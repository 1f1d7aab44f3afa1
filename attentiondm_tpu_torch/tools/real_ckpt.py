"""The real-checkpoint on-ramp (port of `attentiondm_tpu/tools/real_ckpt.py`).

The published DDIM checkpoints and the canonical `pt_inception` FID weights
are not in the repository and are not downloaded.  Once they are placed by
hand, one command runs the whole validation chain:

    python3 -m attentiondm_tpu_torch.tools.real_ckpt [--name ema_cifar10] [--fid N] [--ref_stats S.npz]

1. discover the assets (`--dir`, `$ATTENTIONDM_CKPT_ROOT`,
   ~/.cache/attentiondm, ./assets, the current directory) and md5-verify the
   checkpoint against the registry (`pretrained.MD5_MAP`);
2. convert it by name (`models/torch_convert.py`) and golden-check the
   converted forward against the repository's independent torch oracle
   (`tests/torch_oracle.py`, same weights, same input) at 5e-4.  The golden
   check is mandatory: a missing oracle or a mismatch exits nonzero unless
   --skip_oracle;
3. sample a DDIM grid from the checkpoint (the float model);
4. with pt_inception present, extract its Inception features from the samples;
5. with --fid N: sample N images in batches, stream them through the
   Inception statistics on the device (`eval.fid.sharded_statistics`), save
   mu / sigma, and with reference statistics (`fid_stats_*.npz`, or
   --ref_stats) print the Frechet distance.

Absent assets are reported, not fatal; a failed validation is fatal.  It
runs on the current CUDA device (`--device cpu` for the CPU), float32 under
`exact_f32()`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from .. import default_device
from ..diffusion.sampling import ddim_sample, make_timestep_seq
from ..diffusion.schedules import DiffusionSchedule
from ..models.torch_convert import load_torch_checkpoint
from ..models.unet import UNetConfig, unet_apply
from ..ops.precision import exact_f32
from ..pretrained import CKPT_MAP, MD5_MAP, md5_hash

_INCEPTION_NAMES = ("pt_inception-2015-12-05-6726825d.pth", "pt_inception*.pth")
GOLDEN_TOL = 5e-4


def _search_dirs(extra=()):
    dirs = list(extra)
    env = os.environ.get("ATTENTIONDM_CKPT_ROOT")
    if env:
        dirs.append(env)
    dirs += [os.path.expanduser("~/.cache/attentiondm"), os.path.expanduser("~/.cache/diffusion_models_converted"),
             "assets", "."]
    return [d for d in dirs if os.path.isdir(d)]


def _find(patterns, dirs):
    for d in dirs:
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(d, "**", pat), recursive=True))
            if hits:
                return hits[0]
    return None


def find_real_assets(extra_dirs=()):
    """The reference assets placed by hand: {name: path or None}."""
    dirs = _search_dirs(extra_dirs)
    out = {name: _find([os.path.basename(rel)], dirs) for name, rel in CKPT_MAP.items()}
    out["pt_inception"] = _find(_INCEPTION_NAMES, dirs)
    out["fid_stats"] = _find(["fid_stats_*.npz", "*_fid_stats.npz"], dirs)
    return out


def verify_md5(name: str, path: str) -> bool:
    want = MD5_MAP.get(name)
    return want is None or md5_hash(path) == want


def golden_check(ckpt_path: str, params, cfg: UNetConfig, ema: bool, tol: float = GOLDEN_TOL,
                 required: bool = True, device=None):
    """Load the checkpoint's state dict into the independent torch oracle
    (tests/torch_oracle.py `TorchDDIMUNet`, the original DDIM graph) on the
    CPU and compare its eps with the port's converted forward on the same
    input; returns max |d eps|.  An oracle that cannot be imported raises
    (`required=False`, --skip_oracle, makes it a loud skip returning None)."""
    tests_dir = os.path.join(os.path.dirname(__file__), "..", "..", "tests")
    sys.path.insert(0, os.path.abspath(tests_dir))
    try:
        from torch_oracle import TorchDDIMUNet  # type: ignore
    except Exception as e:
        if required:
            raise RuntimeError(f"torch oracle unavailable ({e}) — the golden check is mandatory; run from a checkout "
                               "with tests/, or pass --skip_oracle to proceed without validation") from e
        print(f"  torch oracle unavailable ({e}) — skipping golden check (--skip_oracle)")
        return None
    finally:
        sys.path.pop(0)

    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, (list, tuple)):
        sd = sd[-1] if ema else sd[0]
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    net = TorchDDIMUNet(ch=cfg.ch, out_ch=cfg.out_ch, ch_mult=tuple(cfg.ch_mult), num_res_blocks=cfg.num_res_blocks,
                        attn_resolutions=tuple(cfg.attn_resolutions), in_channels=cfg.in_channels,
                        resolution=cfg.resolution)
    net.load_state_dict(sd, strict=True)
    net.eval()

    x = np.random.default_rng(0).standard_normal((2, 3, cfg.resolution, cfg.resolution)).astype(np.float32)
    t = np.array([10.0, 500.0], np.float32)
    with torch.no_grad():
        theirs = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        dev = params["conv_in"]["kernel"].device if device is None else torch.device(device)
        with exact_f32():  # the golden check is a correctness authority: no TF32
            ours = unet_apply(params, cfg, torch.from_numpy(x.transpose(0, 2, 3, 1)).to(dev),
                              torch.from_numpy(t).to(dev)).cpu().numpy().transpose(0, 3, 1, 2)
    diff = float(np.abs(ours - theirs).max())
    print(f"  golden check vs torch oracle: max|Δeps| = {diff:.2e}  [{'OK' if diff < tol else 'MISMATCH'}]")
    return diff


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="the real-checkpoint validation chain")
    ap.add_argument("--name", default="ema_cifar10", choices=sorted(CKPT_MAP))
    ap.add_argument("--dir", action="append", default=[], help="extra search dirs")
    ap.add_argument("--sample_batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default="real_ckpt_report.json")
    ap.add_argument("--grid", default="real_ckpt_grid.png", help="where the sample grid is written")
    ap.add_argument("--skip_oracle", action="store_true", help="downgrade a missing torch oracle to a loud skip")
    ap.add_argument("--config", default=None,
                    help="config YAML overriding the name-derived UNetConfig (also how a toy dry run is made)")
    ap.add_argument("--fid", type=int, default=0, metavar="N",
                    help="sample N images and run the full statistics -> Frechet path (requires pt_inception)")
    ap.add_argument("--ref_stats", default=None,
                    help="reference statistics .npz (mu / sigma); a discovered fid_stats_*.npz is used when absent")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def _write(report, path):
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def main(argv=None):
    args = parse_args(argv)
    device = default_device() if args.device is None else torch.device(args.device)
    assets = find_real_assets(args.dir)
    print("discovered assets:")
    for k, v in assets.items():
        print(f"  {k}: {v or '(absent)'}")
    report = {"assets": {k: v for k, v in assets.items() if v}}

    ckpt = assets.get(args.name)
    if ckpt is None:
        print(f"\ncheckpoint for '{args.name}' not found — supply it under $ATTENTIONDM_CKPT_ROOT to run the "
              "validation chain")
        _write(report, args.out)
        return report

    ok = verify_md5(args.name, ckpt)
    print(f"\n[1/5] md5 {'verified' if ok else 'MISMATCH'} for {ckpt}")
    report["md5_ok"] = ok

    if args.config:
        from ..config import load_config

        cfg = UNetConfig.from_config(load_config(args.config))
    elif "lsun" in args.name:
        cfg = UNetConfig(resolution=256, ch_mult=(1, 1, 2, 2, 4, 4), attn_resolutions=(16,))
    else:
        cfg = UNetConfig()  # cifar10
    ema = args.name.startswith("ema_")
    params = load_torch_checkpoint(ckpt, cfg, ema=ema, device=device)
    print("[2/5] converted torch checkpoint by name")
    diff = golden_check(ckpt, params, cfg, ema, required=not args.skip_oracle, device=device)
    report["golden_max_abs_diff"] = diff
    if diff is not None and diff >= GOLDEN_TOL:
        _write(report, args.out)
        sys.exit(f"golden check FAILED: max|Δeps| = {diff:.2e} >= {GOLDEN_TOL} — the conversion does not reproduce "
                 "the reference forward")

    sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=device)
    seq = make_timestep_seq(1000, args.steps, "quad")
    shape = (args.sample_batch, cfg.resolution, cfg.resolution, 3)

    @torch.no_grad()
    def sample(x):
        with exact_f32():
            return ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x, seq, sched.betas)

    xf = sample(torch.randn(shape, generator=torch.Generator(device=device).manual_seed(0), device=device))
    finite = bool(torch.isfinite(xf).all())
    print(f"[3/5] DDIM-{args.steps} sampling from the real checkpoint: finite={finite}")
    report["sampling_finite"] = finite
    from ..utils.images import save_image_grid

    save_image_grid(torch.clamp((xf + 1) / 2, 0, 1).cpu().numpy(), args.grid)

    inc_path = assets.get("pt_inception")
    net = None
    if inc_path:
        from ..eval.inception import InceptionV3FID

        net = InceptionV3FID.from_torch(inc_path, device=device)
        feats = net.extract(torch.clamp((xf + 1) / 2, 0, 1))
        print(f"[4/5] canonical Inception features extracted: {tuple(feats.shape)}")
        report["inception_feat_dim"] = int(feats.shape[-1])
    else:
        print("[4/5] pt_inception absent — KID-proxy remains the fallback metric")

    if args.fid > 0:
        if net is None:
            sys.exit("--fid requires pt_inception weights (canonical FID authority)")
        from ..eval.fid import frechet_smoke_safe, sharded_statistics

        n_batches = (args.fid + args.sample_batch - 1) // args.sample_batch

        def batches():
            # sample -> [0, 1] images -> statistics on the device; only mu and sigma come back to the host
            for i in range(n_batches):
                g = torch.Generator(device=device).manual_seed(1234 * 2 ** 20 + i)
                yield torch.clamp((sample(torch.randn(shape, generator=g, device=device)) + 1) / 2, 0, 1)

        mu, sigma = sharded_statistics(batches(), net.extract, batch_size=args.sample_batch, device=device)
        stats_out = os.path.splitext(args.out)[0] + "_stats.npz"
        np.savez(stats_out, mu=mu, sigma=sigma)
        print(f"[5/5] statistics over {n_batches * args.sample_batch} samples -> {stats_out}")
        report["fid_n"] = n_batches * args.sample_batch
        ref_stats = args.ref_stats or assets.get("fid_stats")
        if ref_stats:
            ref = np.load(ref_stats)
            if report["fid_n"] < sigma.shape[0]:
                print(f"      note: n={report['fid_n']} < {sigma.shape[0]} features — eigenvalue-form Frechet "
                      "(smoke-scale FID only)")
            fid = frechet_smoke_safe(mu, sigma, ref["mu"], ref["sigma"], report["fid_n"])
            print(f"      FID vs {os.path.basename(ref_stats)}: {fid:.3f}")
            report["fid"] = float(fid)
        else:
            print("      no reference fid_stats_*.npz discovered — saved stats for later scoring "
                  "(python -m attentiondm_tpu_torch.eval.fid)")
    else:
        print("[5/5] skipped (--fid 0); the W4A8 serving path's bulk run: main_torch.py --fid")

    _write(report, args.out)
    print(f"report written to {args.out}")
    return report


if __name__ == "__main__":
    main()
