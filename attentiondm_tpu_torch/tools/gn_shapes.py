#!/usr/bin/env python3
"""Device time of K2 and K6 (`ops.fused_gn.epilogue_gn_swish_quant`) at every
resblock epilogue shape of the CIFAR-10 (batch 128), LSUN church (32) and
celeba-wide (64) serving steps.

    python3 attentiondm_tpu_torch/tools/gn_shapes.py [--out FILE.json] [--plans]

The port is imported from the current directory, not from beside this file,
so one script measures two trees on the same card, one after the other (run
it from the root of each; it needs `epilogue_gn_swish_quant(..., plain=)`,
`ops.checks.conv_plan` and `chip_smoke.device_ms`, and prints the launch
plan where the tree has `ops.fused_gn.epilogue_plan`).  Per shape, on bf16
conv1 output as the serving path gives it: the call's device time
(`chip_smoke.device_ms`: CUDA events around 20 calls queued behind a busy
card), whether the output equals the plain version's, and the least time
the card could take (bytes, each input read once and the int8 output
written once, over 3.35 TB/s, or 18 f32 operations an element over 67
TFLOP/s) with the share of it the call reaches.  Prints one line a shape,
the per-step sums, and the card's name and power limit.  `--plans` also
times, at every shape, each K2 plan `ops.fused_gn.k2_plans` offers and K6 at
128, 256 and 512 threads a block (the plan `epilogue_plan` picks is marked
`*`), each checked against the plain version.
"""
import argparse
import collections
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from attentiondm_tpu_torch.config import load_config  # noqa: E402
from attentiondm_tpu_torch.models.unet import UNetConfig  # noqa: E402
from attentiondm_tpu_torch.ops import checks, fused_gn  # noqa: E402

BATCH = {"cifar10": 128, "church": 32, "celeba-wide": 64}


def configs():
    celeba = dataclasses.replace(UNetConfig.from_config(load_config("celeba.yml")), attn_resolutions=(64, 32, 16))
    return {"cifar10": UNetConfig(), "church": UNetConfig.from_config(load_config("church.yml")), "celeba-wide": celeba}


def epilogue_args(B, HW, N, gen, dev):
    """bf16 conv1 output (identity dequant), one channel group at mean 40, as chip_smoke's check."""
    H = int(HW ** 0.5)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    zcbias = torch.zeros(N, device=dev)
    zcbias[:N // 32] = 40.0
    return (randf((B, H, H, N), 2.0, 0.3).to(torch.bfloat16), torch.ones(N, device=dev), zcbias, randf((B, N)),
            randf((N,), 0.1, 1.0), randf((N,), 0.1), torch.full((N,), 255 / 4.5, device=dev),
            torch.full((N,), round(255 / 4.5 * -0.5) + 128.0, device=dev), 8)


def sweep(kind, B, HW, N, a, chosen):
    """Device time of the call under each plan of the shape (see --plans)."""
    if kind == "K2":
        plans = fused_gn.k2_plans(HW, N, 2)
        fn = fused_gn.epilogue_gn_swish_quant_whole
    else:
        V = N // fused_gn.VEC
        plans = [{**chosen, "threads": min(fused_gn.WIN, t // V) * V,
                  "smem": 4 * 2 * N * (min(fused_gn.WIN, t // V) + 1)} for t in (128, 256, 512)]
        fn = fused_gn.epilogue_gn_swish_quant_blocked
    want = fn(*a, plain=True)
    plan_of = fused_gn.epilogue_plan
    try:
        for plan in plans:
            fused_gn.epilogue_plan = lambda *_, plan=plan: plan
            equal = torch.equal(fn(*a), want)
            ms = chip_smoke.device_ms(lambda: fn(*a))
            print(f"  {'*' if plan == chosen else ' '} {kind} B={B} HW={HW} N={N} "
                  + " ".join(f"{k}={v}" for k, v in plan.items() if k != "kind")
                  + f": device {ms * 1e3:.1f} us, equal: {equal}")
    finally:
        fused_gn.epilogue_plan = plan_of


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--plans", action="store_true", help="also time every launch plan at each shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gn_shapes: no CUDA device")
    card = chip_smoke.nvidia_smi_line()
    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(0)
    plan_of = getattr(fused_gn, "epilogue_plan", None)
    rows = []
    for path, cfg in configs().items():
        B = BATCH[path]
        _k1, k2, k6, _k3, _c = checks.conv_plan(cfg)
        totals = collections.defaultdict(lambda: [0.0, 0.0])
        for kind, shapes in (("K2", k2), ("K6", k6)):
            for (HW, N), n in sorted(collections.Counter(shapes).items()):
                a = epilogue_args(B, HW, N, gen, dev)
                got = fused_gn.epilogue_gn_swish_quant(*a)
                equal = torch.equal(got, fused_gn.epilogue_gn_swish_quant(*a, plain=True))
                ms = chip_smoke.device_ms(lambda: fused_gn.epilogue_gn_swish_quant(*a))
                b = max(chip_smoke.bound(chip_smoke.nbytes(*a[:8]) + got.numel(), f32_flops=18 * got.numel()))
                plan = plan_of(B, HW, N, torch.bfloat16, kind) if plan_of else None
                totals[kind][0] += n * ms
                totals[kind][1] += n * b
                rows.append(dict(path=path, kind=kind, B=B, HW=HW, N=N, per_step=n, device_ms=ms, bound_ms=b,
                                 share=b / ms, equal=equal, plan=plan))
                print(f"{path} {kind} B={B} HW={HW} N={N} x{n}/step: device {ms:.4f} ms, bound {b:.4f} ms "
                      f"({b / ms:.1%}), equal to the plain version: {equal}"
                      + (f"; plan {plan}" if plan else ""))
                if args.plans:
                    sweep(kind, B, HW, N, a, plan)
                del a, got
        for kind, (ms, b) in totals.items():
            print(f"== {path}: {kind} device time per serving step {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%})")
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
