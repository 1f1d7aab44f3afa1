"""Attention-precision ablation: four quantization variants, calibrated,
sampled and scored (port of `attentiondm_tpu/tools/ablation_attention.py`).

Variants A (uniform low-bit), B (conv low / attention high), C (conv high /
attention low) and D (uniform high-bit) are fake-quant models
(`quant.qunet.QuantizedUNet`), each calibrated (stage 1) on one shared FP
DDIM trajectory of `calib_batch` images, then sampled (DDPM ancestral by
default, or DDIM) and scored by FID against the FP model's samples
(`eval.fid`), with an optional CLIP score.  Writes `ablation_results.yaml`
and each variant's first 16 samples as PNGs.

    python3 -m attentiondm_tpu_torch.tools.ablation_attention [--config cifar10.yml] [--ckpt F] \\
        [--steps 50] [--num-samples 64] [--batch 32] [--sampler ddpm|ddim] \\
        [--inception-weights F | --inception-random] [--clip-weights DIR | --clip-random] [--device cpu]

FID features: the Inception of `--inception-weights`, or a seeded random
one with `--inception-random` (relative comparisons only), else the mean
colour of each image (JAX's fallback).  It runs on the current CUDA device
unless `device=` names another.  Draws come from torch.Generators (JAX
splits a PRNGKey): the params from `seed` where none are given, the FP
samples' from seed + 1, variant i's (0 to 3) from seed + 1 + 1000 (i + 1)
(JAX folds a salted `hash` of the name into its key), the calibration
images from seed + 2.  `x_init=` ({"fp" or a variant's name: [num_samples,
H, W, C]}) and `x_cal=` hand in the initial noises (a DDPM run still draws
its per-step noise from the run's generator).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict

import numpy as np
import torch
import yaml

from .. import default_device
from ..data.transforms import inverse_data_transform
from ..diffusion.sampling import ddim_sample, ddpm_sample, make_timestep_seq
from ..diffusion.schedules import DiffusionSchedule
from ..eval.fid import calculate_activation_statistics, calculate_frechet_distance
from ..models.unet import UNetConfig, iter_conv_layers, unet_apply, unet_init
from ..quant.calibrate import calibrate_ranges
from ..quant.qunet import QuantizedUNet, make_bit_policy
from ..quant.state import ActQuantConfig
from ..utils.images import save_image

VARIANTS = {
    # name: (conv_bits, attention_bits)
    "A_uniform_low": (4, 4),
    "B_conv_low_attn_high": (4, 8),
    "C_conv_high_attn_low": (8, 4),
    "D_uniform_high": (8, 8),
}


def make_variant_policy(cfg: UNetConfig, conv_bits: int, attn_bits: int):
    """Per-variant policy: attention projections at attn_bits (the key
    still gets the max(4, b - 2) downgrade), everything else at conv_bits."""
    policy = dict(make_bit_policy(cfg, conv_bits))
    for name, _cin, _k in iter_conv_layers(cfg):
        leaf = name.rsplit(".", 1)[-1]
        if ".attn" in name or name.startswith("mid.attn"):
            if leaf in ("k", "key_conv"):
                b = max(4, attn_bits - 2)
                policy[name] = ActQuantConfig(w_bit=b, a_bit=b, group_num=8)
            elif leaf in ("v", "value_conv"):
                policy[name] = ActQuantConfig(w_bit=attn_bits, a_bit=attn_bits, group_num=4)
            else:
                policy[name] = ActQuantConfig(w_bit=attn_bits, a_bit=attn_bits, group_num=8)
    return policy


@dataclasses.dataclass
class AblationConfig:
    sampler: str = "ddpm"  # the reference's ancestral sampling
    steps: int = 50
    num_samples: int = 64
    batch: int = 32
    calib_batch: int = 2
    seed: int = 0


def calibrate_variant(cfg: UNetConfig, params, conv_bits: int, attn_bits: int, xs_in, seq, device):
    """(the variant's QuantizedUNet, its stage-1 states) calibrated on the
    trajectory inputs `xs_in` [S, N, H, W, C]."""
    qunet = QuantizedUNet(cfg=cfg, policy=make_variant_policy(cfg, conv_bits, attn_bits))
    qstates = calibrate_ranges(qunet, params, qunet.init_state(len(seq), device), xs_in, seq, first=True)
    return qunet, qstates


def run_attention_ablation(config, out_dir: str, *, params=None, extractor=None,
                           ablation_cfg: AblationConfig | None = None, clip_scorer=None, device=None,
                           x_init: Dict[str, torch.Tensor] | None = None, x_cal=None):
    """Run the four variants; {variant: {"conv_bits", "attention_bits",
    "fid_vs_fp", "seconds"[, "clip_score"]}}.  `extractor(x01 [N, H, W, C]
    on the device) -> [N, D]` gives the FID features (default: each image's
    mean colour, for relative comparisons only); `clip_scorer(images01
    numpy)` is optional."""
    acfg = ablation_cfg or AblationConfig()
    device = default_device() if device is None else torch.device(device)
    cfg = UNetConfig.from_config(config)
    betas = DiffusionSchedule.from_config(config, device=device).betas
    if params is None:
        params = unet_init(torch.Generator().manual_seed(acfg.seed), cfg, device)
    seq = make_timestep_seq(betas.shape[0], acfg.steps, "uniform")
    shape = (cfg.resolution, cfg.resolution, cfg.in_channels)
    os.makedirs(out_dir, exist_ok=True)
    sampler = ddpm_sample if acfg.sampler == "ddpm" else ddim_sample

    def fp_fn(xt, t, i):
        return unet_apply(params, cfg, xt, t)

    @torch.no_grad()
    def sample_with(model_fn, run: str, seed: int):
        g = torch.Generator(device=device).manual_seed(seed)
        imgs, done = [], 0
        while done < acfg.num_samples:
            n = min(acfg.batch, acfg.num_samples - done)
            if x_init is not None:
                x = x_init[run][done:done + n].to(device)
            else:
                x = torch.randn((n, *shape), generator=g, device=device)
            out = sampler(model_fn, x, seq, betas, generator=g)
            imgs.append(inverse_data_transform(config, out).cpu().numpy())
            done += n
        return np.concatenate(imgs)

    t0 = time.time()
    fp_imgs = sample_with(fp_fn, "fp", acfg.seed + 1)
    logging.info(f"FP reference samples: {fp_imgs.shape[0]} in {time.time() - t0:.1f}s")

    if extractor is None:
        def extractor(x):
            return x.reshape(x.shape[0], -1, cfg.in_channels).mean(dim=1)

    mu_fp, sig_fp = calculate_activation_statistics([fp_imgs], extractor, device=device)

    # the calibration trajectory, shared by the variants
    xc = x_cal.to(device) if x_cal is not None else torch.randn(
        (acfg.calib_batch, *shape), generator=torch.Generator(device=device).manual_seed(acfg.seed + 2), device=device)
    with torch.no_grad():
        _, traj, _ = ddim_sample(fp_fn, xc, seq, betas, keep_trajectory=True)
    xs_in = torch.cat([xc[None], traj[:-1]], dim=0)

    results: Dict[str, dict] = {}
    for i, (vname, (conv_b, attn_b)) in enumerate(VARIANTS.items()):
        t0 = time.time()
        qunet, qstates = calibrate_variant(cfg, params, conv_b, attn_b, xs_in, seq, device)
        qparams, _ = qunet.prepare_params(params)
        imgs = sample_with(qunet.model_fn(qparams, qstates), vname, acfg.seed + 1 + 1000 * (i + 1))
        vdir = os.path.join(out_dir, vname)
        for j in range(min(16, imgs.shape[0])):
            save_image(imgs[j], os.path.join(vdir, f"{j}.png"))
        mu, sig = calculate_activation_statistics([imgs], extractor, device=device)
        fid = calculate_frechet_distance(mu_fp, sig_fp, mu, sig)
        entry = {"conv_bits": conv_b, "attention_bits": attn_b, "fid_vs_fp": float(fid),
                 "seconds": round(time.time() - t0, 1)}
        if clip_scorer is not None:
            entry["clip_score"] = float(clip_scorer(imgs))
        results[vname] = entry
        logging.info(f"{vname}: FID {fid:.3f} ({entry['seconds']}s)")

    with open(os.path.join(out_dir, "ablation_results.yaml"), "w") as f:
        yaml.dump(results, f, default_flow_style=False)
    return results


def build_parser():
    """The CLI's argument parser (run_attention_ablation_torch.sh passes its flags)."""
    import argparse

    ap = argparse.ArgumentParser(description="attention-precision ablation (variants A-D)")
    ap.add_argument("--config", default="cifar10.yml")
    ap.add_argument("--out", default="ablation_out")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--num-samples", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"])
    ap.add_argument("--inception-weights", default=None)
    ap.add_argument("--inception-random", action="store_true",
                    help="FID features of a seeded random-init Inception (scores comparable within this run only)")
    ap.add_argument("--clip-weights", default=None, help="local HuggingFace CLIP checkpoint dir")
    ap.add_argument("--clip-random", action="store_true",
                    help="seeded random-init CLIP (scores comparable within this run only)")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    return ap


def main(argv=None):
    from ..config import load_config
    from .activation_range import load_weights

    args = build_parser().parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = default_device() if args.device is None else torch.device(args.device)
    config = load_config(args.config)
    cfg = UNetConfig.from_config(config)
    params = load_weights(args.ckpt, cfg, device) if args.ckpt else None
    extractor = None
    if args.inception_weights or args.inception_random:
        from ..eval.inception import InceptionV3FID

        net = (InceptionV3FID.from_torch(args.inception_weights, device=device) if args.inception_weights
               else InceptionV3FID.random(0, device=device))
        extractor = net.extract
    clip_scorer = None
    if args.clip_weights:
        from ..eval.clip_score import make_clip_scorer

        clip_scorer = make_clip_scorer(args.clip_weights, device=device)
    elif args.clip_random:
        from ..eval.clip_score import make_random_clip_scorer

        logging.info("CLIP: seeded random-init (within-run comparison only)")
        clip_scorer = make_random_clip_scorer(device=device)
    res = run_attention_ablation(config, args.out, params=params, extractor=extractor, clip_scorer=clip_scorer,
                                 device=device, ablation_cfg=AblationConfig(sampler=args.sampler, steps=args.steps,
                                                                            num_samples=args.num_samples,
                                                                            batch=args.batch))
    print(yaml.dump(res))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
