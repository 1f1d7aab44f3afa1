#!/usr/bin/env python3
"""Device time of the attention cores at every shape the serving steps of the
CIFAR-10, LSUN church and celeba-wide configurations give them: K3
(`fused_attention_block`, f32 core and int8 core), K8, K9 and K10.

    python3 attentiondm_tpu_torch/tools/attn_shapes.py [--out FILE.json]

The port is imported from the current directory, not from beside this file,
so one script measures two trees on the same card, one after the other (run
it from the root of each; it needs only the four wrappers' signatures and
`ops.checks.conv_plan` / `attention_plan`).  Per shape, from torch.profiler
(CUPTI), mean of 5 calls: the call's device time (every kernel it launches)
and the core kernel's own (`attn_core_kernel` in K3, `int8_attn_core_kernel`
in K8 / K9 / K10), the least time the card could take for the call (bytes
over 3.35 TB/s or operations over the peak of their type: 1,979 TOP/s int8,
989 TFLOP/s bf16, 495 / 3 TFLOP/s for K3's f32 products as 3xTF32, 67 TFLOP/s
f32 elsewhere), and whether the output meets the kernel's tolerance against
its plain version.  Prints one line a shape, the per-step sums, and the
card's name and power limit.
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
from attentiondm_tpu_torch.ops import checks  # noqa: E402
from attentiondm_tpu_torch.ops import int8_attention as ia  # noqa: E402

BATCH = {"cifar10": 128, "church": 32, "celeba-wide": 64}
HBM, INT8, BF16, TF32X3, F32 = 3.35e12, 1979e12, 989e12, 495e12 / 3, 67e12


def configs():
    celeba = dataclasses.replace(UNetConfig.from_config(load_config("celeba.yml")), attn_resolutions=(64, 32, 16))
    return {"cifar10": UNetConfig(), "church": UNetConfig.from_config(load_config("church.yml")), "celeba-wide": celeba}


def device_us(fn, core, reps=5, tries=10):
    """(call, core kernel) mean device µs a call over a profiler window.  A
    window can come back without some launches, or empty: then it is taken
    again after a pause."""
    for i in range(tries):
        time.sleep(0.5 * i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_time_total > 0 and not e.key.startswith(("aten::", "cuda"))]
        cores = [e for e in rows if core in e.key]
        if cores and sum(e.count for e in cores) == reps:
            return sum(e.device_time_total for e in rows) / reps, sum(e.device_time_total for e in cores) / reps
    raise AssertionError(f"torch.profiler recorded no complete window of {core}")


def bound_us(nbytes, int8=0.0, bf16=0.0, tf32x3=0.0, f32=0.0):
    return max(nbytes / HBM, int8 / INT8 + bf16 / BF16 + tf32x3 / TF32X3 + f32 / F32) * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_shapes: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(0)

    def i8(shape, lo=-127, hi=127):
        return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)

    def f(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    rows = []

    def run(path, kind, B, L, C, n, fn, core, bound):
        got, want = fn(), fn(plain=True)
        fig = checks.compare("K3" if kind.startswith("K3") else kind, got, want)
        call, own = device_us(fn, core)
        rows.append(dict(path=path, kernel=kind, B=B, L=L, C=C, per_step=n, call_us=round(call, 2),
                         core_us=round(own, 2), bound_us=round(bound, 2), ok=fig["ok"]))
        print(f"{path} {kind} B={B} L={L} C={C} x{n}/step: call {call:.2f} us, {core} {own:.2f} us, bound "
              f"{bound:.2f} us ({bound / call * 100:.1f}% of the call), within tolerance: {fig['ok']}")
        return n * call, n * own, n * bound

    for path, cfg in configs().items():
        B = BATCH[path]
        sums = collections.defaultdict(lambda: [0.0, 0.0, 0.0])
        k3 = collections.Counter(checks.conv_plan(cfg)[3])
        modes = [False, True] if path == "celeba-wide" else [False]
        for (L, C), n in sorted(k3.items()):
            x = f((B, L, C)).to(torch.bfloat16)
            qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b) for b in (8, 6, 8)]
            qkv_w = [(i8((C, C), -8, 7), f((C,), 1e-5, 2e-4).abs(), f((C,), 0.1)) for _ in range(3)]
            o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
            o_w = (i8((C, C), -8, 7), f((C,), 1e-5, 1e-3).abs(), f((C,), 0.1))
            a = (x, f((C,), 0.1, 1.0), f((C,), 0.1), qkv_quant, qkv_w, o_quant, o_w)
            for int8_core in modes:
                kind = "K3.int8_core" if int8_core else "K3"
                ops = dict(int8=4 * 2 * B * L * C * C + (2 * B * L * L * C if int8_core else 0),
                           tf32x3=(1 if int8_core else 2) * 2 * B * L * L * C, f32=30 * x.numel() + 5 * B * L * L)
                s = run(path, kind, B, L, C, n, lambda plain=False, a=a, c=int8_core: ia.fused_attention_block(
                    *a, scale=C ** -0.5, int8_core=c, plain=plain), "attn_core_kernel",
                        bound_us(2 * x.numel() * 2 + 4 * C * C + 16 * 4 * C, **ops))
                sums[kind] = [u + v for u, v in zip(sums[kind], s)]
            del x, a
        if path == "celeba-wide":
            settings = {"static": dict(attn_int8=True, attn_ranges=True), "dynamic": dict(attn_int8=True)}
            for name, flags in settings.items():
                plan = checks.attention_plan(cfg, **flags)
                for kind in ("K10", "K9", "K8"):
                    for (L, C), n in sorted(collections.Counter(plan[kind]).items()):
                        osc, ozp = torch.full((C,), 255 / 4.0, device=dev), f((C,), 3.0).round()
                        ops = dict(int8=2 * B * L * L * C, bf16=2 * B * L * L * C, f32=5 * B * L * L)
                        if kind == "K8":
                            d = [torch.randint(-20000, 20000, (B, L, C), generator=gen, dtype=torch.int32).to(dev)
                                 for _ in range(3)]
                            e = [(f((C,), 2e-5, 1e-4).abs(), f((C,), 0.2)) for _ in range(3)]

                            def fn(plain=False, d=d, e=e, osc=osc, ozp=ozp, C=C):
                                return ia.fused_int8_attention(*d, *e, osc, ozp, 8, scale=C ** -0.5, plain=plain)

                            b = bound_us(13 * B * L * C + 8 * 4 * C, **{**ops, "f32": ops["f32"] + 12 * B * L * C})
                        else:
                            q8, k8, v8 = (i8((B, L, C)) for _ in range(3))
                            sq, sk, sv = (torch.tensor(v, device=dev) for v in (0.019, 0.021, 0.02))

                            def fn(plain=False, q8=q8, k8=k8, v8=v8, sq=sq, sk=sk, sv=sv, osc=osc, ozp=ozp, C=C):
                                return ia.fused_int8_attention_static(q8, k8, v8, sq, sk, sv, osc, ozp, 8,
                                                                      scale=C ** -0.5, plain=plain)

                            b = bound_us(4 * B * L * C + 8 * C + 12, **ops)
                        s = run(path, kind, B, L, C, n, fn, "int8_attn_core_kernel", b)
                        sums[kind] = [u + v for u, v in zip(sums[kind], s)]
                        torch.cuda.empty_cache()
        for kind, (call, own, bound) in sums.items():
            print(f"== {path}: {kind} per serving step: calls {call / 1e3:.3f} ms, core kernel {own / 1e3:.3f} ms, "
                  f"bound {bound / 1e3:.3f} ms")
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
