"""Interleaved A/B of the ddim variant's headline sampler against the
enhanced attention variant, with and without its stage-3 mixed-precision
core, on the card (port of `attentiondm_tpu/tools/bench_enhanced_mp.py`).

The same operating point for all three arms (CIFAR-10, DDIM-100 quad,
W4A8, batch 128, the bf16 residual stream, the f32 attention core):
stage-1 ranges on the FP teacher's trajectory of 2 images; the MP arm's
states from `calibrate_mp_attention` at timesteps 0 / 250 / 500 / 750 / 999
on the teacher's last images, at base bits 4.  The enhanced blocks' gamma
is seeded nonzero (JAX's init of 0 makes every block the identity, which
would not change the work but would the images).  The arms run in turns,
`--reps` rounds, each run between CUDA events ending on a device sync.

    python3 -m attentiondm_tpu_torch.tools.bench_enhanced_mp [--reps 6] [--batch 128] [--steps 100]
        [--ch 128] [--device cpu] [--out FILE.json]
"""
from __future__ import annotations

import argparse

import torch

from ..models.unet import UNetConfig, unet_init
from ..quant.int8_serving import serving_ddim_sampler
from . import probe


def _enhanced_params(cfg, device):
    params = unet_init(torch.Generator().manual_seed(0), cfg, device)
    gen = torch.Generator().manual_seed(1)
    for lvl in params["down"] + params["up"]:
        for a in lvl["attn"]:
            a["gamma"].fill_(0.5 + float(torch.rand(1, generator=gen)))
    params["mid"]["attn_1"]["gamma"].fill_(0.5 + float(torch.rand(1, generator=gen)))
    return params


def build_sampler(cfg, steps: int, device, mp: bool):
    from ..quant.attention_mp import calibrate_mp_attention, init_mp_attention_state, make_logit_collector

    params = _enhanced_params(cfg, device) if cfg.attn_variant == "enhanced" else None
    params, qunet, qstates, seq, betas = probe.calibrated(cfg, steps, device, params=params)
    mp_states = None
    if mp:
        imgs = probe.images(cfg, 2, 1, device)
        collector = make_logit_collector(params, cfg, imgs)
        probe_ts = [0, 250, 500, 750, 999]
        states = {n: init_mp_attention_state(1000, device) for n in collector(probe_ts[0])}
        mp_states = calibrate_mp_attention(collector, states, base_bits=4, timesteps=probe_ts)
    return serving_ddim_sampler(qunet, params, qstates, seq, betas, residual_dtype=torch.bfloat16, attn_int8=False,
                                mp_states=mp_states, mp_base_bits=4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ch", type=int, default=128, help="the UNet's base width (CIFAR-10's 128)")
    args = probe.add_common(ap).parse_args(argv)
    device = probe.device_of(args.device)
    arms = {"ddim (headline)": build_sampler(UNetConfig(ch=args.ch), args.steps, device, mp=False),
            "enhanced": build_sampler(UNetConfig(ch=args.ch, attn_variant="enhanced"), args.steps, device, mp=False),
            "enhanced+MP": build_sampler(UNetConfig(ch=args.ch, attn_variant="enhanced"), args.steps, device,
                                         mp=True)}
    x = probe.images(UNetConfig(ch=args.ch), args.batch, 2, device)
    with torch.no_grad():
        finite = {n: bool(torch.isfinite(fn(x)).all()) for n, fn in arms.items()}
        times = probe.interleaved({n: (lambda fn=fn: fn(x)) for n, fn in arms.items()}, device, rounds=args.reps)
    best = {n: min((t for t in ts if t is not None), default=None) for n, ts in times.items()}
    ips = {n: None if t is None else args.batch / (t * 1e-3) for n, t in best.items()}
    base = ips["ddim (headline)"]
    rec = {"img_per_s": ips, "ms": best, "rounds": times, "finite": finite,
           "enhanced_vs_ddim": None if base is None else ips["enhanced"] / base,
           "enhanced_mp_vs_ddim": None if base is None else ips["enhanced+MP"] / base}
    for n in arms:
        print(f"{n:18s} " + ("-" if ips[n] is None else f"{ips[n]:7.1f} img/s"))
    return probe.emit("bench_enhanced_mp", device, args, rec, args.out)


if __name__ == "__main__":
    main()
