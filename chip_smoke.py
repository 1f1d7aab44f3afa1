#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`attentiondm_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--steps 10] [--batch 128] [--seed 0] [--profile]

1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the CUDA kernels from attentiondm_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card at the
   CIFAR-10 serving shapes (batch --batch), with times (CUDA events, median
   of 20 launches): K1 at every int8 conv shape of a serving step (its
   int32 mode at the 3x3 shapes is K13's check, its 1x1 mode at the
   nin_shortcut shapes is K5's), K2 at every resblock shape, K3 at both
   attention shapes.  A kernel's `ms` / `plain_ms` in the JSON line is the
   sum over one serving step's launches of it (K13 and K5 are the int32
   3x3 and the 1x1 launches among K1's);
4. slice: the full-width CIFAR-10 UNet (UNetConfig()) at W4A8 with seeded
   random weights: FP DDIM teacher trajectory on 2 images, stage-1
   calibration, the per-step fold and the int8 serving DDIM sampler
   (--steps quad steps; --steps 100 is bench.py's schedule).  Checks the
   output, each kernel's launch count against the count the model's
   structure predicts, and one serving step against the same step through
   the plain versions.
Prints a JSON line of per-kernel results, then {"ok": true, "device": ...}
as the last line.  Any failure raises (nonzero exit, no result line); so
does a machine without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def conv_plan(cfg):
    """Per serving step: the K1 launches (name, H_in, Cp, Np, ksize, stride,
    out dtype), the K2 shapes (HW, N) and the K3 shapes (L, C), derived from
    `iter_conv_layers` and the config."""
    import torch

    from attentiondm_tpu_torch.models.unet import iter_conv_layers
    from attentiondm_tpu_torch.quant.int8_runtime import _eligible

    def rup(c):
        return (c + 127) // 128 * 128

    levels = len(cfg.ch_mult)
    res = [cfg.resolution >> i for i in range(levels)]
    k1, k2, k3 = [], [], []
    for name, cin, k in iter_conv_layers(cfg):
        parts = name.split(".")
        if not _eligible((k, k, cin, 0)):
            continue
        if parts[0] == "mid":
            lvl = levels - 1
        elif parts[0] == "conv_out":
            lvl = 0
        else:
            lvl = int(parts[1])
        H, cout = res[lvl], cfg.ch * cfg.ch_mult[lvl]
        if ".attn" in name or parts[0] == "mid" and parts[1] == "attn_1":
            if parts[-1] == "q":
                k3.append((H * H, cin))
            continue
        stride, mode = 1, torch.int32
        if parts[-1] in ("conv1", "conv2"):
            cout = cin if parts[0] == "mid" else cout
            mode = torch.bfloat16
            if parts[-1] == "conv1":
                k2.append((H * H, cout))
        elif parts[0] == "conv_out":
            cout = cfg.out_ch
        elif parts[-2] == "downsample":
            cout, stride = cin, 2
        elif parts[-2] == "upsample":
            cout, H = cin, 2 * H
        k1.append((name, H, rup(cin), rup(cout), k, stride, mode))
    return k1, k2, k3


def time_ms(fn, reps: int = 20) -> float:
    """Median per-call time in ms, CUDA events around each call, after a warm-up."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


class Report:
    """Per-kernel error, time and main-path count, for the JSON line."""

    def __init__(self):
        self.rows = {}

    def add(self, key, err, ms, plain_ms, weight=1):
        r = self.rows.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += weight * ms
        r["plain_ms"] += weight * plain_ms


def kernel_phase(cfg, batch, gen, dev, report):
    import torch

    from attentiondm_tpu_torch.ops.fused_gn import epilogue_gn_swish_quant
    from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
    from attentiondm_tpu_torch.ops.pallas_conv import int8_conv

    k1, k2, k3 = conv_plan(cfg)

    def randint8(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    # K1: every distinct (H, Cp, Np, ksize, stride, mode) of a step, weighted by its count.
    # K13 (int32 3x3) is checked at every 3x3 stride-1 shape, and weighted by the
    # path's own int32 launches at that shape (0 where the path runs it in bf16 mode).
    counts = {}
    for _name, *shape in k1:
        counts[tuple(shape)] = counts.get(tuple(shape), 0) + 1
    s1_shapes = sorted({(H, Cp, Np) for (H, Cp, Np, k, s, _m) in counts if k == 3 and s == 1})
    print(f"[kernels] K1 int8_conv: {len(counts)} distinct launch shapes per serving step")
    checks = [(shape, n, "K1") for shape, n in sorted(counts.items(), key=str)]
    checks += [((H, Cp, Np, 3, 1, torch.int32), counts.get((H, Cp, Np, 3, 1, torch.int32), 0), "K13")
               for (H, Cp, Np) in s1_shapes]
    checks += [(shape, n, "K5") for shape, n in sorted(counts.items(), key=str) if shape[3] == 1]
    for (H, Cp, Np, k, s, mode), n, key in checks:
        Hp = H + 2 if (k == 3 and s == 1) else H + 1 if k == 3 else H
        xp = randint8((batch, Hp, Hp, Cp), -128, 127)
        gq = randint8((k * k * Cp, Np), -8, 7)
        inv_ws, zcbias = randf((Np,), 1e-3, 2e-3).abs(), randf((Np,), 0.5)
        args = (xp, gq, inv_ws, zcbias)
        kw = dict(ksize=k, stride=s, out_dtype=mode)
        got = int8_conv(*args, **kw)
        want = int8_conv(*args, **kw, plain=True)
        torch.cuda.synchronize()
        if mode == torch.int32:
            err = (got - want).abs().max().item()
            ok = err == 0  # integer products: exact
        else:
            # bf16 of the same f32 epilogue: equal, at most 1 bf16 ulp apart
            gf, wf = got.float(), want.float()
            err = (gf - wf).abs().max().item()
            ulp = torch.clamp(wf.abs(), min=torch.finfo(torch.float32).tiny) * 2.0 ** -7
            ok = bool(((gf - wf).abs() <= ulp).all())
        if not ok:
            raise AssertionError(f"{key} int8_conv H={H} Cp={Cp} Np={Np} k={k} s={s} {mode}: err {err}")
        ms = time_ms(lambda: int8_conv(*args, **kw))
        pms = time_ms(lambda: int8_conv(*args, **kw, plain=True), reps=10)
        report.add(key, err, ms, pms, weight=n)
        print(f"[kernels] {key} int8_conv B={batch} H={H} Cp={Cp} Np={Np} k={k} s={s} "
              f"{str(mode).removeprefix('torch.')} x{n}/step: max_abs_err {err} kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms")
    int8_conv.launches, int8_conv.launches_by_mode = 0, {}

    # K2: bf16 conv1 output (identity epilogue) at every resblock shape
    k2_counts = {}
    for shape in k2:
        k2_counts[shape] = k2_counts.get(shape, 0) + 1
    for (HW, N), n in sorted(k2_counts.items()):
        H = int(HW ** 0.5)
        dot = randf((batch, H, H, N), 2.0, 0.3).to(torch.bfloat16)
        args = (dot, torch.ones(N, device=dev), torch.zeros(N, device=dev), randf((batch, N)),
                randf((N,), 0.1, 1.0), randf((N,), 0.1), torch.full((N,), 255 / 4.5, device=dev),
                torch.full((N,), round(255 / 4.5 * -0.5) + 128.0, device=dev), 8)
        got = epilogue_gn_swish_quant(*args)
        want = epilogue_gn_swish_quant(*args, plain=True)
        torch.cuda.synchronize()
        d = (got.int() - want.int()).abs()
        err, frac = d.max().item(), (d > 0).float().mean().item()
        # float-order ties only: <= 1 LSB on <= 0.1% of elements
        if err > 1 or frac > 1e-3:
            raise AssertionError(f"K2 HW={HW} N={N}: max {err} LSB on {frac:.2e} of elements")
        ms = time_ms(lambda: epilogue_gn_swish_quant(*args))
        pms = time_ms(lambda: epilogue_gn_swish_quant(*args, plain=True), reps=10)
        report.add("K2", err, ms, pms, weight=n)
        print(f"[kernels] K2 epilogue_gn_swish_quant B={batch} HW={HW} N={N} x{n}/step: max {err} LSB "
              f"on {frac:.2e} kernel {ms:.4f} ms plain {pms:.4f} ms")
    epilogue_gn_swish_quant.launches = 0

    # K3: both attention shapes (the k projection at a_bit 6, as the W4A8 policy)
    k3_counts = {}
    for shape in k3:
        k3_counts[shape] = k3_counts.get(shape, 0) + 1
    for (L, C), n in sorted(k3_counts.items()):
        x = randf((batch, L, C)).to(torch.bfloat16)
        qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b) for b in (8, 6, 8)]
        qkv_weights = [(randint8((C, C), -8, 7), randf((C,), 1e-5, 2e-4).abs(), randf((C,), 0.1))
                       for _ in range(3)]
        o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
        o_weights = (randint8((C, C), -8, 7), randf((C,), 1e-5, 1e-3).abs(), randf((C,), 0.1))
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant, qkv_weights, o_quant, o_weights)
        got = fused_attention_block(*args, scale=C ** -0.5)
        want = fused_attention_block(*args, scale=C ** -0.5, plain=True)
        torch.cuda.synchronize()
        gf, wf = got.float(), want.float()
        d = (gf - wf).abs()
        rel = (d.mean() / wf.abs().mean()).item()
        within = (d <= wf.abs() * 2.0 ** -7 + 1e-30).float().mean().item()
        if not (rel < 1e-3 and within >= 0.99):
            raise AssertionError(f"K3 L={L} C={C}: mean rel err {rel:.3e}, {within:.4f} within 1 ulp")
        ms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        pms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5, plain=True), reps=10)
        report.add("K3", d.max().item(), ms, pms, weight=n)
        print(f"[kernels] K3 fused_attention_block B={batch} L={L} C={C} x{n}/step: mean rel err {rel:.3e}, "
              f"{within:.5f} within 1 bf16 ulp, max_abs_err {d.max().item():.4g} kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms")
    fused_attention_block.launches = 0


def profile_sampler(run, wall_ms, top: int = 25):
    """torch.profiler over one sampler run: device time per kernel, and its
    share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", 0)
        if dt and not e.key.startswith(("aten::", "cuda")):
            rows.append((dt / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"[profile] device kernel time {total:.1f} ms over one sampler run of {wall_ms:.1f} ms wall "
          f"(timed without the profiler)")
    for ms, n, key in rows[:top]:
        print(f"[profile] {ms:9.2f} ms {n:6d}x {key[:110]}")


def slice_phase(cfg, steps, batch, gen, dev, profile=False):
    """Drive the main path once; returns (launch counts, expected counts)."""
    import torch

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, make_timestep_seq
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import count_params, unet_apply, unet_init
    from attentiondm_tpu_torch.ops.fused_gn import epilogue_gn_swish_quant
    from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
    from attentiondm_tpu_torch.ops.pallas_conv import int8_conv
    from attentiondm_tpu_torch.quant.calibrate import calibrate_ranges
    from attentiondm_tpu_torch.quant.int8_serving import (
        prepare_serving_runtime,
        runtime_nbytes,
        serving_ddim_sampler,
        serving_unet_apply,
    )
    from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

    def clock(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"[slice] {label}: {time.perf_counter() - t0:.2f} s")
        return out

    params = unet_init(gen, cfg, dev)
    print(f"[slice] UNetConfig() CIFAR-10: {count_params(params) / 1e6:.2f}M params, W4A8, "
          f"{steps} quad steps, batch {batch}")
    sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=dev)
    seq = make_timestep_seq(1000, steps, "quad")
    x_small = torch.randn((2, 32, 32, 3), generator=gen).to(dev)
    _, traj, _ = clock("FP teacher trajectory (2 images)", lambda: ddim_sample(
        lambda xt, t, i: unet_apply(params, cfg, xt, t), x_small, seq, sched.betas, keep_trajectory=True))
    xs_in = torch.cat([x_small[None], traj[:-1]])
    qunet = QuantizedUNet.create(cfg, 4, 8)
    qstates = clock("stage-1 calibration", lambda: calibrate_ranges(
        qunet, params, qunet.init_state(steps, dev), xs_in, seq))
    runtime = clock("per-step fold", lambda: prepare_serving_runtime(qunet, params, qstates))
    print(f"[slice] fold size: {runtime_nbytes(runtime) / 1e9:.3f} GB for {steps} steps")
    sample = serving_ddim_sampler(qunet, params, qstates, seq, sched.betas, runtime=runtime)
    x = torch.randn((batch, 32, 32, 3), generator=gen).to(dev)

    k1, k2, k3 = conv_plan(cfg)
    expected = {"K1": len(k1) * steps, "K2": len(k2) * steps, "K3": len(k3) * steps,
                "K5": sum(1 for c in k1 if c[4] == 1) * steps,
                "K13": sum(1 for c in k1 if c[4] == 3 and c[5] == 1 and c[6] == torch.int32) * steps}

    # the main path, counted
    int8_conv.launches, int8_conv.launches_by_mode = 0, {}
    epilogue_gn_swish_quant.launches = 0
    fused_attention_block.launches = 0
    out = clock(f"serving sampler, first run ({steps} steps, batch {batch})", lambda: sample(x))
    by_mode = dict(int8_conv.launches_by_mode)
    counts = {"K1": int8_conv.launches, "K2": epilogue_gn_swish_quant.launches,
              "K3": fused_attention_block.launches, "K5": by_mode.get("1x1/s1/int32", 0),
              "K13": by_mode.get("3x3/s1/int32", 0)}
    print(f"[slice] launches {counts} (by K1 mode {by_mode}), expected {expected}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    if tuple(out.shape) != (batch, 32, 32, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sampler output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")

    best = min(time_ms(lambda: sample(x), reps=1) for _ in range(2))
    print(f"[slice] serving sampler: {best:.1f} ms for {steps} steps at batch {batch} = "
          f"{batch / best * 1e3:.2f} images/s ({best / steps:.2f} ms/step; information only)")
    if profile:
        profile_sampler(lambda: sample(x), best)

    # one serving step through the kernels vs the plain versions, on the card
    t0 = torch.full((batch,), float(seq[-1]), device=dev)

    def step(plain):
        return serving_unet_apply(params, cfg, qunet, runtime, qstates, x, t0, 0, plain=plain)

    eps, eps_p = step(False), step(True)
    rel = ((eps - eps_p).abs().mean() / eps_p.abs().mean()).item()
    print(f"[slice] one serving step, kernels vs plain versions: mean rel err {rel:.3e} "
          f"(bit-identical: {torch.equal(eps, eps_p)})")
    if not rel < 5e-3:  # the single-step tolerance of the CPU parity tests
        raise AssertionError(f"serving step kernels vs plain: mean rel err {rel}")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler's device time per kernel for one sampler run")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the GPU")
    from attentiondm_tpu_torch.models.unet import UNetConfig
    from attentiondm_tpu_torch.ops import _build

    card = nvidia_smi_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    so, seconds = _build.build()
    _build.kernels()
    print(f"[build] {so.name}: {seconds:.1f} s (nvcc, sm_90a)")

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    cfg = UNetConfig()
    report = Report()
    kernel_phase(cfg, args.batch, gen, dev, report)
    counts = slice_phase(cfg, args.steps, args.batch, gen, dev, args.profile)

    meta = {
        "K1": ("int8_conv (implicit-GEMM int8 conv, all modes)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
               "attentiondm_tpu/ops/pallas_conv.py:97"),
        "K13": ("int8_conv int32 3x3 mode (_conv3x3_int8_dot)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
                "attentiondm_tpu/ops/quant_conv.py:116"),
        "K5": ("int8_conv 1x1 mode (int8_matmul)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
               "attentiondm_tpu/ops/quant_conv.py:57"),
        "K2": ("epilogue_gn_swish_quant", "attentiondm_tpu_torch/csrc/fused_gn.cu",
               "attentiondm_tpu/ops/fused_gn.py:188"),
        "K3": ("fused_attention_block", "attentiondm_tpu_torch/csrc/int8_attention.cu",
               "attentiondm_tpu/ops/int8_attention.py:448"),
    }
    kernels = []
    for key in ("K1", "K13", "K5", "K2", "K3"):
        name, source, replaces = meta[key]
        r = report.rows[key]
        kernels.append({"name": f"{key} {name}", "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[key], "max_abs_err": r["max_abs_err"],
                        "ms": round(r["ms"], 4), "plain_ms": round(r["plain_ms"], 4)})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
