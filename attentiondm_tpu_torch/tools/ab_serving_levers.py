"""One interleaved A/B of the serving path's levers at the headline
operating point, on the card (port of
`attentiondm_tpu/tools/ab_serving_levers.py`).

CIFAR-10, DDIM-100 quad, W4A8, batch 128, the bf16 residual stream, the f32
attention core; JAX's variant dictionary with its names and settings
(`VARIANTS`), every sampler built over one shared fold (`runtime=`), then
timed in turns (`--reps` rounds, CUDA events around each run, each ending
on a device sync).  Each variant's final images are held against `base`'s
on the same input: the mean relative deviation (the levers round at most
one 8-bit activation LSB apart).  In the port `conv_pallas` routes every
value through K1 (the only conv kernel), so its variants measure that
flag's bookkeeping, not another kernel.

    python3 -m attentiondm_tpu_torch.tools.ab_serving_levers [--variants dot_bf16,bf] [--batch 128]
        [--steps 100] [--reps 3] [--ch 128] [--device cpu] [--out FILE.json]
"""
from __future__ import annotations

import argparse

import torch

from ..models.unet import UNetConfig
from ..quant.int8_serving import prepare_serving_runtime, serving_ddim_sampler
from . import probe

# JAX's dictionary: name -> serving flags ("base" is the shipping configuration)
VARIANTS = {
    "base": dict(),
    "dot_bf16": dict(dot_bf16=True),
    "entry_pallas": dict(entry_pallas=True),
    "both": dict(dot_bf16=True, entry_pallas=True),
    "bf": dict(boundary_fusion=True),
    "bf+dot_bf16": dict(boundary_fusion=True, dot_bf16=True),
    "bf+both": dict(boundary_fusion=True, dot_bf16=True, entry_pallas=True),
    "conv_pallas": dict(conv_pallas=True),
    "conv_pallas_all": dict(conv_pallas="all"),
    "cp16": dict(conv_pallas=((16, 256, 256),)),
    "cp8": dict(conv_pallas=((8, 256, 256),)),
    "rb": dict(resblock_pallas=True),
    "rb_all": dict(resblock_pallas="all"),
    "conv_pallas+rb": dict(conv_pallas=True, resblock_pallas=True),
    "no_dot_bf16": dict(dot_bf16=False),
}


def samplers(cfg, steps: int, device, names):
    """{name: sampler} over one fold."""
    params, qunet, qstates, seq, betas = probe.calibrated(cfg, steps, device)
    rt = prepare_serving_runtime(qunet, params, qstates)
    return {name: serving_ddim_sampler(qunet, params, qstates, seq, betas, residual_dtype=torch.bfloat16,
                                       attn_int8=False, runtime=rt, **VARIANTS[name]) for name in names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None, help="comma-separated subset of VARIANTS (default: all); 'base' "
                                                     "is always included")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ch", type=int, default=128, help="the UNet's base width (CIFAR-10's 128)")
    args = probe.add_common(ap).parse_args(argv)
    names = list(VARIANTS)
    if args.variants:
        keep = {"base"} | set(args.variants.split(","))
        if not keep <= set(VARIANTS):
            raise SystemExit(f"ab_serving_levers: unknown variants {sorted(keep - set(VARIANTS))}")
        names = [n for n in VARIANTS if n in keep]
    device = probe.device_of(args.device)
    cfg = UNetConfig(ch=args.ch)
    runs = samplers(cfg, args.steps, device, names)
    x0 = probe.images(cfg, args.batch, 2, device)
    with torch.no_grad():
        ref = runs["base"](x0)
        dev = {}
        for name in names:
            out = runs[name](x0)
            dev[name] = float((out - ref).abs().mean() / (ref.abs().mean() + 1e-9))
        times = probe.interleaved({n: (lambda s=runs[n]: s(x0)) for n in names}, device, rounds=2 * args.reps)
    best = {n: min((t for t in times[n] if t is not None), default=None) for n in names}
    base = best["base"]
    rows = []
    for n in names:
        ms = best[n]
        ips = None if ms is None else args.batch / (ms * 1e-3)
        rows.append(dict(variant=n, flags={k: (list(map(list, v)) if isinstance(v, tuple) else v)
                                           for k, v in VARIANTS[n].items()},
                         ms=ms, img_per_s=ips, vs_base=None if ms is None else base / ms - 1.0,
                         mean_rel_vs_base=dev[n], rounds=times[n]))
        print(f"{n:16s} " + ("-" if ms is None else f"{ips:7.1f} img/s ({(base / ms - 1) * 100:+.1f}% vs base)")
              + f"  mean-rel |{n} - base| {dev[n]:.3e}")
    return probe.emit("ab_serving_levers", device, args, {"rows": rows}, args.out)


if __name__ == "__main__":
    main()
