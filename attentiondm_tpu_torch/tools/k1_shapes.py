#!/usr/bin/env python3
"""Device time of K1 (`ops.pallas_conv.int8_conv`) at every shape the serving
steps of the CIFAR-10, LSUN church and celeba-wide configurations launch.

    python3 attentiondm_tpu_torch/tools/k1_shapes.py [--out FILE.json]

The port is imported from the current directory, not from beside this file,
so one script measures two trees on the same card, one after the other (run
it from the root of each; it needs only `int8_conv(xp, gq, inv_ws, zcbias, ksize=, stride=,
out_dtype=)` and `ops.checks.conv_plan`, and hands the weights' K-major copy
over where the tree has `k_major`).  Per shape: the kernel's own duration as
torch.profiler (CUPTI) records it, mean of 5 launches, whether the output
equals the plain version's, and the least time the card could take (bytes
over 3.35 TB/s or int8 operations over 1,979 TOP/s).  Prints one line a
shape, the per-step sums, and the card's name and power limit.
"""
import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from attentiondm_tpu_torch.config import load_config  # noqa: E402
from attentiondm_tpu_torch.models.unet import UNetConfig  # noqa: E402
from attentiondm_tpu_torch.ops import checks, pallas_conv  # noqa: E402

BATCH = {"cifar10": 128, "church": 32, "celeba-wide": 64}


def configs():
    celeba = dataclasses.replace(UNetConfig.from_config(load_config("celeba.yml")), attn_resolutions=(64, 32, 16))
    return {"cifar10": UNetConfig(), "church": UNetConfig.from_config(load_config("church.yml")), "celeba-wide": celeba}


def kernel_us(fn, reps=5, tries=10):
    """Mean duration of the launches a profiler window recorded.  A window can
    come back without some of them, or empty, several windows in a row: then
    it is taken again after a pause."""
    for i in range(tries):
        time.sleep(0.5 * i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if "igemm_kernel" in e.key and e.device_time_total > 0]
        if rows:
            return sum(e.device_time_total for e in rows) / sum(e.count for e in rows)
    raise AssertionError("torch.profiler recorded no igemm_kernel launch")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_shapes: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(0)
    k_major = getattr(pallas_conv, "k_major", None)
    rows = []
    for path, cfg in configs().items():
        B = BATCH[path]
        counts = collections.Counter(tuple(shape) for _name, *shape in checks.conv_plan(cfg)[0])
        total = bound_total = 0.0
        for (H, Cp, Np, k, s, mode), n in sorted(counts.items(), key=str):
            Hp = H + 2 if (k == 3 and s == 1) else H + 1 if k == 3 else H
            xp = torch.randint(-128, 128, (B, Hp, Hp, Cp), generator=gen, dtype=torch.int8).to(dev)
            gq = torch.randint(-8, 8, (k * k * Cp, Np), generator=gen, dtype=torch.int8).to(dev)
            inv_ws, zcbias = torch.rand(Np, device=dev) * 1e-3 + 1e-4, torch.randn(Np, device=dev)
            kw = dict(ksize=k, stride=s, out_dtype=mode)
            want = pallas_conv.int8_conv(xp, gq, inv_ws, zcbias, **kw, plain=True)
            if k_major is not None:
                kw["gqt"] = k_major(gq)
            out = pallas_conv.int8_conv(xp, gq, inv_ws, zcbias, **kw)
            equal = torch.equal(out, want)
            us = kernel_us(lambda: pallas_conv.int8_conv(xp, gq, inv_ws, zcbias, **kw))
            nbytes = xp.numel() + gq.numel() + out.numel() * out.element_size()
            bound = max(nbytes / 3.35e12, 2 * out.numel() * gq.shape[0] / 1979e12) * 1e6
            total, bound_total = total + n * us, bound_total + n * bound
            rows.append(dict(path=path, B=B, H=H, Cp=Cp, Np=Np, ksize=k, stride=s, out=str(mode).removeprefix("torch."),
                             per_step=n, device_us=round(us, 2), bound_us=round(bound, 2), equal=equal))
            print(f"{path} B={B} H={H} Cp={Cp} Np={Np} k={k} s={s} {rows[-1]['out']} x{n}/step: device {us:.2f} us, "
                  f"bound {bound:.2f} us, equal to the plain version: {equal}")
            del xp, gq, out, want
        print(f"== {path}: K1 device time per serving step {total / 1e3:.3f} ms, bound {bound_total / 1e3:.3f} ms")
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
