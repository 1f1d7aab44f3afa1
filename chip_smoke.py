#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`attentiondm_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--steps 10] [--seed 0] [--profile]

(`--profile` adds, after the last phase, torch.profiler's device time per
kernel for one run of each sampler.)

1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the CUDA kernels from attentiondm_tpu_torch/csrc/;
3. then the CIFAR-10 W4A8 sampler (`UNetConfig()`, batch 128) and the LSUN
   church W4A8 sampler (`configs/church.yml`, 256^2, batch 32, at most 4
   steps), both with the f32 attention core (`attn_int8=False`):
   a. kernels: each kernel against its plain PyTorch version on the card at
      every distinct shape the path's serving step gives it
      (`ops.checks.conv_plan`), held to its tolerance (`ops.checks.compare`),
      with times (CUDA events, median of 20 launches, 10 for the plain
      version): K1 at every int8 conv shape (its int32 mode at the 3x3
      shapes is K13's check, its 1x1 mode at the shortcut shapes K5's), K2
      and K6 at every resblock epilogue shape as the router sends them
      (`epilogue_phase`: bit-equal to the plain version, the launch plan and
      the share of the bound printed; at K6's shapes K2 is also run and
      timed against K6; one int32-input check a kernel), K3 at every
      attention shape.  K4, K7 and K12 at every shape a serving step launches
      under the three levers together or one alone (`ops.checks.lever_plan`).
      A kernel's `ms` / `device_ms` / `plain_ms` / `bound_ms` in the JSON
      line is the sum over one serving step's launches of it (the step with
      all three levers for K4, K7 and K12).  `ms` includes the Python
      wrapper; `device_ms` leaves its host time out: CUDA events around
      20 calls queued behind a busy card, which then runs them back to back.
      `bound_ms` is the least time the card could take: per launch the
      larger of its bytes (every input read once, every output written
      once) over 3.35 TB/s and its operations over the
      peak of their type (1,979 TOP/s int8 and 989 TFLOP/s bf16 on the tensor
      cores, 495 / 3 TFLOP/s for f32 products run there as 3xTF32, 67
      TFLOP/s f32 outside them); `library_ms` times the one PyTorch call that
      computes the same function, where there is one (`torch._int_mm` for
      K5, `F.scaled_dot_product_attention` for K3's core alone), and is null
      elsewhere.  `K3.core` is K3's f32 core timed alone through its own C
      entry point (`ops.int8_attention.attention_core`) on f32 q, k, v at K3's
      shapes; its launches are the path's K3 launches, each of which runs
      that kernel once;
   b. slice: the full-width UNet at W4A8 with seeded random weights: FP DDIM
      teacher trajectory on 2 images, stage-1 calibration, the per-step fold
      and the int8 serving DDIM sampler (--steps quad steps; --steps 100 is
      bench.py's schedule).  Checks the output's shape and finiteness and
      each kernel's launch count against `ops.checks.expected_launches`;
      then one serving step teacher-forced, every kernel call held to its
      tolerance against its plain version on the same inputs
      (`ops.checks.per_site`), and the whole step through the kernels
      against the whole step through the plain versions (printed, held to a
      gross-fault bound);
   c. levers: the same params, calibration and fold with `entry_pallas`,
      `boundary_fusion` and `resblock_pallas="all"`.  CIFAR-10: the sampler
      again with all three (launch counts of K4, K7, K12 and the changed
      K1 / K2 counts against `expected_launches`), the per-site step and the
      chained step under the levers, and timed runs in turns of levers off,
      all three, and each lever alone (the median of each is printed).  Church: one per-site step with the
      three levers, launch counts checked.
4. celeba-wide: CelebA's UNet (`configs/celeba.yml`: 64^2, ch 128, ch_mult
   1-2-2-2-4, batch 64) at full width and depth with `attn_resolutions` set
   to (64, 32, 16), so that it attends at L = 4096 (C = 128), 1024 (C = 256),
   256 (C = 256) and 16 (C = 512), the one model that reaches every attention
   kernel:
   a. kernels: K10, K9, K8, K11 and K3 with its int8 core against their plain
      versions at every shape a serving step gives them under the three
      attention settings (`ops.checks.attention_plan`), timed as above, and
      K2 at every epilogue shape as in 3a; K11
      also beside `F.scaled_dot_product_attention`, the library call for its
      function (`library_ms`; K8, K9 and K10 have none: no PyTorch call takes
      int8 q and k and returns an int8 requantized output);
   b. slice: FP teacher on 2 images (K11 at 10 sites a forward), stage-1
      calibration with the attention ranges, the fold, then the serving
      sampler under each setting: `attn_int8=True` with `attn_ranges` (K10,
      K9 and K3's int8 core), `attn_int8=True` without (K8 at the 64^2 and
      32^2 sites, K3's int8 core) and `attn_int8=False` (K11
      and K3's f32 core); launch counts, shape and finiteness, the per-site
      step and the chained step for each, and (information only) how far the
      two int8-core samples lie from the f32-core sample.
Prints a JSON line of per-kernel results, then {"ok": true, "device": ...}
as the last line.  Any failure raises (nonzero exit, no result line); so
does a machine without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

CHAINED_BOUND = 0.1  # whole step, kernels vs plain versions: mean relative error (gross faults only)
BATCH = {"cifar10": 128, "church": 32, "celeba-wide": 64}
MAX_STEPS = {"church": 4}  # a shallower schedule where the path is long and an earlier phase
LEVER_ROUNDS = 3  # timed runs per lever setting, taken in turns
F32_CORE = dict(attn_int8=False)  # the attention flag of the CIFAR-10 and church paths (bench.py's)
# the three attention settings of the celeba-wide path; attn_ranges=True stands for the calibrated ranges
ATTN_SETTINGS = {"static int8": dict(attn_int8=True, attn_ranges=True), "dynamic int8": dict(attn_int8=True),
                 "f32 core": F32_CORE}

META = {  # kernel -> (wrapper, source, the TPU kernel it replaces)
    "K1": ("int8_conv (implicit-GEMM int8 conv, all modes)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
           "attentiondm_tpu/ops/pallas_conv.py:97"),
    "K13": ("int8_conv int32 3x3 mode (_conv3x3_int8_dot)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
            "attentiondm_tpu/ops/quant_conv.py:116"),
    "K5": ("int8_conv 1x1 mode (int8_matmul)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
           "attentiondm_tpu/ops/quant_conv.py:57"),
    "K2": ("epilogue_gn_swish_quant_whole", "attentiondm_tpu_torch/csrc/fused_gn.cu",
           "attentiondm_tpu/ops/fused_gn.py:188"),
    "K6": ("epilogue_gn_swish_quant_blocked", "attentiondm_tpu_torch/csrc/fused_gn_blocked.cu",
           "attentiondm_tpu/ops/fused_gn.py:432"),
    "K3": ("fused_attention_block", "attentiondm_tpu_torch/csrc/int8_attention.cu",
           "attentiondm_tpu/ops/int8_attention.py:448"),
    "K4": ("gn_act_quant", "attentiondm_tpu_torch/csrc/gn_act_quant.cu", "attentiondm_tpu/ops/fused_gn.py:109"),
    "K7": ("epilogue_residual_gn_stats", "attentiondm_tpu_torch/csrc/epilogue_residual_gn_stats.cu",
           "attentiondm_tpu/ops/fused_gn.py:292"),
    "K12": ("resblock_pallas", "attentiondm_tpu_torch/csrc/resblock.cu",
            "attentiondm_tpu/ops/pallas_resblock.py:114"),
    "K8": ("fused_int8_attention", "attentiondm_tpu_torch/csrc/int8_attn_core.cu",
           "attentiondm_tpu/ops/int8_attention.py:73"),
    "K9": ("fused_int8_attention_static", "attentiondm_tpu_torch/csrc/int8_attn_core.cu",
           "attentiondm_tpu/ops/int8_attention.py:159"),
    "K10": ("int8_flash_attention_static", "attentiondm_tpu_torch/csrc/int8_attn_core.cu",
            "attentiondm_tpu/ops/int8_attention.py:270"),
    "K11": ("flash_attention", "attentiondm_tpu_torch/csrc/flash_attention.cu", "attentiondm_tpu/ops/attention.py:53"),
    "K3.int8_core": ("fused_attention_block(int8_core=True)", "attentiondm_tpu_torch/csrc/int8_attention.cu",
                     "attentiondm_tpu/ops/int8_attention.py:448"),
    # the core kernel of K3's chain alone; each K3 launch on the path runs it once
    "K3.core": ("attention_core (K3's f32 core alone)", "attentiondm_tpu_torch/csrc/int8_attention.cu",
                "attentiondm_tpu/ops/int8_attention.py:448"),
}
# which sampler run of the celeba-wide path a kernel's launch count is read from
ATTN_RUN = {"K10": "static int8", "K9": "static int8", "K3.int8_core": "static int8", "K8": "dynamic int8",
            "K11": "f32 core"}
ALL_LEVERS = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
LEVER_SETS = {"all three": ALL_LEVERS, "entry_pallas": dict(entry_pallas=True),
              "boundary_fusion": dict(boundary_fusion=True), "resblock_pallas=all": dict(resblock_pallas="all")}

# the card's published peaks (H100 SXM data sheet), for `bound_ms`
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12  # tensor cores, dense
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
# f32 products on the tensor cores as 3xTF32 (K3's core): three TF32 products (495 TFLOP/s dense) for each.
# One TF32 pass would be faster but rounds each operand to 10 bits, which K3's tolerance does not allow
# (1.3% of proj_out's input codes flip), so the split is the least work that computes the function.
TF32X3_FLOPS_PER_S = 495e12 / 3


def bound(nbytes, int8_ops=0, f32_flops=0, bf16_flops=0, tf32x3_flops=0):
    """(bytes ms, operations ms) the card needs at least for one launch."""
    ops = (int8_ops / INT8_OPS_PER_S + bf16_flops / BF16_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S
           + tf32x3_flops / TF32X3_FLOPS_PER_S)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops * 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def path_config(path):
    """(UNetConfig, DiffusionSchedule, label) of a path: CIFAR-10's default
    config, the church model loaded from the repository's church.yml, or
    CelebA's from celeba.yml with attention at 64^2, 32^2 and 16^2."""
    import dataclasses

    from attentiondm_tpu_torch.config import load_config
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import UNetConfig

    if path == "cifar10":
        return UNetConfig(), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000), "UNetConfig() CIFAR-10"
    if path == "celeba-wide":
        config = load_config("celeba.yml")
        cfg = dataclasses.replace(UNetConfig.from_config(config), attn_resolutions=(64, 32, 16))
        return cfg, DiffusionSchedule.from_config(config), "celeba.yml CelebA with attn_resolutions=(64, 32, 16)"
    config = load_config("church.yml")
    return (UNetConfig.from_config(config), DiffusionSchedule.from_config(config),
            "church.yml LSUN church_outdoor")


SPIN_CYCLES = 40_000_000  # about 20 ms of torch.cuda._sleep at the H100's clocks (`device_ms`)


def device_ms(fn, reps: int = 20) -> float:
    """Device time in ms of one call of `fn`, the wrapper's host time left
    out: CUDA events around `reps` calls that the host enqueues while the card
    still runs a spin kernel, so the card then runs them back to back.  An
    event behind the spin kernel that has not completed when the last call is
    enqueued shows that every call waited on the card; if it has, the spin is
    made four times as long and the measurement taken again.  The figure
    holds everything the wrapper launches: its own kernels and, for K3, the
    few small torch kernels that pack its vectors."""
    import torch

    fn()
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    cycles = SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not spun.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("device_ms: the host could not enqueue the calls while the card was busy")


def time_ms(fn, reps: int = 20, warm: bool = True) -> float:
    """Median per-call time in ms, CUDA events around each call, after a warm-up."""
    import torch

    if warm:
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
    """Per-kernel error and time, summed over one serving step's launches."""

    def __init__(self):
        self.rows = {}

    def add(self, key, err, ms, plain_ms, bound_ms, weight=1, library_ms=None, dev_ms=0.0):
        r = self.rows.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                       "bound_ms": 0.0,
                                       "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += weight * ms
        r["device_ms"] += weight * dev_ms
        r["plain_ms"] += weight * plain_ms
        r["bound_ms"] += weight * max(bound_ms)
        r["bytes_ms"] += weight * bound_ms[0]
        r["ops_ms"] += weight * bound_ms[1]
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + weight * library_ms


def weights_kmajor(gq, inv_ws, zcbias):
    """K3's weight tuple as the serving path hands it: with the fold's K-major copy."""
    from attentiondm_tpu_torch.ops.pallas_conv import k_major

    return gq, inv_ws, zcbias, k_major(gq)


def _fig(f) -> str:
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in f.items())


def _bound_fig(b) -> str:
    return f"bound {max(b):.4f} ms ({'bytes' if b[0] >= b[1] else 'operations'})"


def _held(kind, label, got, want):
    from attentiondm_tpu_torch.ops import checks

    f = checks.compare(kind, got, want)
    if not f["ok"]:
        raise AssertionError(f"{kind} {label}: {f}")
    return f


def epilogue_phase(cfg, batch, gen, dev, report):
    """K2 and K6 at every resblock epilogue shape of a serving step, as the
    router sends the bf16 conv1 output (identity epilogue; the first channel
    group at a large offset, mean 40, where float32 E[x^2] - mu^2 cancels):
    the launch plan, equality to the bit with the plain version, times, the
    bound and the share of it the device time reaches.  At K6's shapes K2 runs
    too, for its time.  Then one int32-input check a kernel (the conv's
    accumulator with inv_ws / zcbias) at the kernel's largest shape."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.fused_gn import (
        epilogue_gn_swish_quant,
        epilogue_gn_swish_quant_blocked,
        epilogue_gn_swish_quant_whole,
        epilogue_plan,
    )

    _k1, k2, k6, _k3, _composed = checks.conv_plan(cfg)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    def args_of(HW, N, x_dtype):
        H = int(HW ** 0.5)
        if x_dtype == torch.int32:
            dot = torch.randint(-20000, 20000, (batch, H, H, N), generator=gen, dtype=torch.int32).to(dev)
            inv_ws, zcbias = randf((N,), 2e-5, 1e-4).abs(), randf((N,))
        else:
            dot = randf((batch, H, H, N), 2.0, 0.3).to(torch.bfloat16)
            inv_ws, zcbias = torch.ones(N, device=dev), torch.zeros(N, device=dev)
        zcbias[:N // 32] += 40.0
        return (dot, inv_ws, zcbias, randf((batch, N)), randf((N,), 0.1, 1.0), randf((N,), 0.1),
                torch.full((N,), 255 / 4.5, device=dev), torch.full((N,), round(255 / 4.5 * -0.5) + 128.0, device=dev),
                8)

    def equal(kind, label, got, want):
        f = _held(kind, label, got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} {label}: not bit-equal to its plain version ({f})")
        return f

    def plan_fig(kind, HW, N, x_dtype):
        p = epilogue_plan(batch, HW, N, x_dtype, kind)
        if kind == "K6":
            return f"plan: {p['blocks_per_image']} chunk items an image, {p['threads']} threads, one launch"
        return (f"plan: {p['cluster']} blocks an image ({batch * p['cluster']} blocks), {p['rows']} rows a block, "
                f"{p['threads']} threads, slab {'held in shared memory' if p['held'] else 're-read from L2'}")

    for kind, shapes in (("K2", k2), ("K6", k6)):
        for (HW, N), n in sorted(collections.Counter(shapes).items()):
            args = args_of(HW, N, torch.bfloat16)
            f = equal(kind, f"HW={HW} N={N}", epilogue_gn_swish_quant(*args), epilogue_gn_swish_quant(*args, plain=True))
            ms = time_ms(lambda: epilogue_gn_swish_quant(*args))
            dms = device_ms(lambda: epilogue_gn_swish_quant(*args))
            pms = time_ms(lambda: epilogue_gn_swish_quant(*args, plain=True), reps=10)
            # 18 f32 operations per element: the TPU kernel's own cost estimate
            b = bound(nbytes(*args[:8]) + args[0].numel(), f32_flops=18 * args[0].numel())
            report.add(kind, f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
            print(f"[kernels] {kind} epilogue_gn_swish_quant B={batch} HW={HW} N={N} x{n}/step: {_fig(f)}, bit-equal; "
                  f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}, device at "
                  f"{max(b) / dms:.1%} of it; {plan_fig(kind, HW, N, torch.bfloat16)}")
            if kind == "K6":
                f2 = equal("K2", f"HW={HW} N={N} (at K6's shape)", epilogue_gn_swish_quant_whole(*args),
                           epilogue_gn_swish_quant_whole(*args, plain=True))
                ms2 = time_ms(lambda: epilogue_gn_swish_quant_whole(*args))
                dms2 = device_ms(lambda: epilogue_gn_swish_quant_whole(*args))
                print(f"[kernels] K6 vs K2 B={batch} HW={HW} N={N}: K6 {ms:.4f} ms (device {dms:.4f}), K2 {ms2:.4f} ms "
                      f"(device {dms2:.4f}; {_fig(f2)}; {plan_fig('K2', HW, N, torch.bfloat16)}), K6's plain version "
                      f"{pms:.4f} ms")
            del args
        if shapes:  # the int32 input mode (the conv's accumulator), at the kernel's largest shape on this path
            HW, N = max(shapes)
            args = args_of(HW, N, torch.int32)
            fn = epilogue_gn_swish_quant_whole if kind == "K2" else epilogue_gn_swish_quant_blocked
            f = equal(kind, f"HW={HW} N={N} int32", fn(*args), fn(*args, plain=True))
            dms = device_ms(lambda: fn(*args))
            b = bound(nbytes(*args[:8]) + args[0].numel(), f32_flops=18 * args[0].numel())
            print(f"[kernels] {kind} int32 input B={batch} HW={HW} N={N}: {_fig(f)}, bit-equal; device {dms:.4f} ms "
                  f"{_bound_fig(b)}, device at {max(b) / dms:.1%} of it; {plan_fig(kind, HW, N, torch.int32)}")
            del args
    torch.cuda.empty_cache()


def kernel_phase(cfg, batch, gen, dev, report):
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.fused_gn import epilogue_residual_gn_stats, gn_act_quant
    import torch.nn.functional as F

    from attentiondm_tpu_torch.ops.int8_attention import attention_core, fused_attention_block
    from attentiondm_tpu_torch.ops.pallas_conv import int8_conv, k_major
    from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas
    from attentiondm_tpu_torch.ops.precision import exact_f32

    k1, _k2, _k6, k3, _composed = checks.conv_plan(cfg)

    def randint8(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    # K1: every distinct (H, Cp, Np, ksize, stride, mode) of a step, weighted by its count.
    # K13 (int32 3x3) is checked at every 3x3 stride-1 shape, and weighted by the
    # path's own int32 launches at that shape (0 where the path runs it in bf16 mode).
    counts = collections.Counter(tuple(shape) for _name, *shape in k1)
    s1_shapes = sorted({(H, Cp, Np) for (H, Cp, Np, k, s, _m) in counts if k == 3 and s == 1})
    print(f"[kernels] K1 int8_conv: {len(counts)} distinct launch shapes per serving step")
    todo = [(shape, n, "K1") for shape, n in sorted(counts.items(), key=str)]
    todo += [((H, Cp, Np, 3, 1, torch.int32), counts.get((H, Cp, Np, 3, 1, torch.int32), 0), "K13")
             for (H, Cp, Np) in s1_shapes]
    todo += [(shape, n, "K5") for shape, n in sorted(counts.items(), key=str) if shape[3] == 1]
    for (H, Cp, Np, k, s, mode), n, key in todo:
        Hp = H + 2 if (k == 3 and s == 1) else H + 1 if k == 3 else H
        xp = randint8((batch, Hp, Hp, Cp), -128, 127)
        gq = randint8((k * k * Cp, Np), -8, 7)
        inv_ws, zcbias = randf((Np,), 1e-3, 2e-3).abs(), randf((Np,), 0.5)
        args = (xp, gq, inv_ws, zcbias)
        kw = dict(ksize=k, stride=s, out_dtype=mode)
        want = int8_conv(*args, **kw, plain=True)
        _held("K1", f"H={H} Cp={Cp} Np={Np} k={k} s={s} {mode} (weights transposed by the call)",
              int8_conv(*args, **kw), want)
        kw["gqt"] = k_major(gq)  # as the serving path calls it: the fold's K-major copy beside gq
        out = int8_conv(*args, **kw)
        f = _held("K1", f"H={H} Cp={Cp} Np={Np} k={k} s={s} {mode}", out, want)
        del want
        ms = time_ms(lambda: int8_conv(*args, **kw))
        dms = device_ms(lambda: int8_conv(*args, **kw))
        pms = time_ms(lambda: int8_conv(*args, **kw, plain=True), reps=10)
        b = bound(nbytes(xp, gq, out) + (0 if mode == torch.int32 else nbytes(inv_ws, zcbias)),
                  int8_ops=2 * out.numel() * gq.shape[0], f32_flops=0 if mode == torch.int32 else 2 * out.numel())
        lib, lib_fig = None, ""
        if key == "K5":  # the one library call for an int8 product: torch's private cuBLASLt int8 matmul
            a2 = xp.reshape(-1, Cp)
            try:
                lib_out = torch._int_mm(a2, gq)
            except RuntimeError as e:  # the yardstick is not available here: say why, time nothing
                lib_fig = f" torch._int_mm none ({str(e).splitlines()[0][:80]})"
            else:
                if not torch.equal(lib_out.reshape(out.shape), out):
                    raise AssertionError(f"torch._int_mm disagrees with K5 at H={H} Cp={Cp} Np={Np}")
                lib = time_ms(lambda: torch._int_mm(a2, gq))
                lib_fig = f" torch._int_mm {lib:.4f} ms"
                del lib_out
        report.add(key, f["max_abs_err"], ms, pms, b, weight=n, library_ms=lib, dev_ms=dms)
        print(f"[kernels] {key} int8_conv B={batch} H={H} Cp={Cp} Np={Np} k={k} s={s} "
              f"{str(mode).removeprefix('torch.')} x{n}/step: {_fig(f)}; kernel {ms:.4f} ms device {dms:.4f} ms "
              f"plain {pms:.4f} ms"
              f"{lib_fig} {_bound_fig(b)}")
        del xp, gq, args, out

    epilogue_phase(cfg, batch, gen, dev, report)

    # K3: every attention shape (the k projection at a_bit 6, as the W4A8 policy)
    for (L, C), n in sorted(collections.Counter(k3).items()):
        x = randf((batch, L, C)).to(torch.bfloat16)
        qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b) for b in (8, 6, 8)]
        qkv_weights = [weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 2e-4).abs(), randf((C,), 0.1))
                       for _ in range(3)]
        o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
        o_weights = weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 1e-3).abs(), randf((C,), 0.1))
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant, qkv_weights, o_quant, o_weights)
        f = _held("K3", f"L={L} C={C}", fused_attention_block(*args, scale=C ** -0.5),
                  fused_attention_block(*args, scale=C ** -0.5, plain=True))
        ms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        dms = device_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        pms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5, plain=True), reps=10)
        # in and out residual, four folds; int8 projections, f32 core (q k^T and p v as 3xTF32), ~30 f32 per
        # element around and 5 per logit
        b = bound(2 * nbytes(x) + 4 * C * C + 16 * 4 * C, int8_ops=4 * 2 * batch * L * C * C,
                  tf32x3_flops=2 * 2 * batch * L * L * C, f32_flops=30 * x.numel() + 5 * batch * L * L)
        report.add("K3", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K3 fused_attention_block B={batch} L={L} C={C} x{n}/step: {_fig(f)}; "
              f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        del x, args

        # K3's core alone on f32 q, k, v of a few units; F.scaled_dot_product_attention computes its function
        # up to the int8 quantization of the output (timed, not held)
        q, k, v = (randf((batch, L, C)) for _ in range(3))
        so, zo = torch.full((C,), 255 / 4.0, device=dev), randf((C,), 3.0).round()

        def core(plain=False):
            return attention_core(q, k, v, so, zo, 8, scale=C ** -0.5, plain=plain)

        f = _held("K3.core", f"L={L} C={C}", core(), core(plain=True))
        ms, dms = time_ms(core), device_ms(core)
        pms = time_ms(lambda: core(plain=True), reps=10)
        with exact_f32():
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=C ** -0.5))
        b = bound(3 * nbytes(q) + q.numel() + 2 * 4 * C, tf32x3_flops=2 * 2 * batch * L * L * C,
                  f32_flops=5 * batch * L * L)
        report.add("K3.core", f["max_abs_err"], ms, pms, b, weight=n, library_ms=lib, dev_ms=dms)
        print(f"[kernels] K3.core attention_core B={batch} L={L} C={C} x{n}/step: {_fig(f)}; kernel {ms:.4f} ms "
              f"device {dms:.4f} ms plain {pms:.4f} ms F.scaled_dot_product_attention {lib:.4f} ms {_bound_fig(b)}")
        del q, k, v
    torch.cuda.empty_cache()

    # K4, K7, K12: every shape a step launches under the three levers together (the
    # weight n of the JSON line's sums) or under one lever alone (m, printed)
    plans = {name: checks.lever_plan(cfg, batch, **kw) for name, kw in LEVER_SETS.items()}
    alone = {"K4": "entry_pallas", "K7": "boundary_fusion", "K12": "resblock_pallas=all"}

    def shapes(kind):
        both = collections.Counter(tuple(shape) for _site, *shape in plans["all three"][kind])
        single = collections.Counter(tuple(shape) for _site, *shape in plans[alone[kind]][kind])
        return [(shape, both[shape], single[shape]) for shape in sorted(set(both) | set(single))]

    def quant(C, lo, hi):  # an 8-bit range [lo, hi] as (scale, zero point)
        sc = 255 / (hi - lo)
        return torch.full((C,), sc, device=dev), torch.full((C,), round(sc * lo) + 128.0, device=dev)

    for (HW, C), n, m in shapes("K4"):  # bf16 residual, one output, swish; one group at offset 40
        x = randf((batch, HW, C), 2.0, 0.3)
        x[..., :C // 32] += 40.0
        x = x.to(torch.bfloat16)
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), [(*quant(C, -0.5, 4.0), 8)])
        f = _held("K4", f"HW={HW} C={C}", gn_act_quant(*args), gn_act_quant(*args, plain=True))
        ms = time_ms(lambda: gn_act_quant(*args))
        dms = device_ms(lambda: gn_act_quant(*args))
        pms = time_ms(lambda: gn_act_quant(*args, plain=True), reps=10)
        b = bound(nbytes(x) + x.numel() + 4 * 4 * C, f32_flops=16 * x.numel())  # 12 + 4 per output, as the TPU estimate
        report.add("K4", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K4 gn_act_quant B={batch} HW={HW} C={C} x{n}/step (entry_pallas alone x{m}): {_fig(f)}; "
              f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        del x, args

    for (HW, N), n, m in shapes("K7"):  # bf16 conv2 output (identity dequant), f32 shortcut branch, bf16 out
        H = int(HW ** 0.5)
        dot = randf((batch, H, H, N), 1.5, 0.2).to(torch.bfloat16)
        args = (dot, torch.ones(N, device=dev), torch.zeros(N, device=dev), randf((batch, H, H, N), 2.0, 0.5))
        kw = dict(out_dtype=torch.bfloat16)
        got = epilogue_residual_gn_stats(*args, **kw)
        f = _held("K7", f"HW={HW} N={N}", got, epilogue_residual_gn_stats(*args, **kw, plain=True))
        ms = time_ms(lambda: epilogue_residual_gn_stats(*args, **kw))
        dms = device_ms(lambda: epilogue_residual_gn_stats(*args, **kw))
        pms = time_ms(lambda: epilogue_residual_gn_stats(*args, **kw, plain=True), reps=10)
        b = bound(nbytes(*args, *got), f32_flops=8 * dot.numel())
        report.add("K7", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K7 epilogue_residual_gn_stats B={batch} HW={HW} N={N} x{n}/step (boundary_fusion alone "
              f"x{m}): {_fig(f)}; kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        del dot, args, got

    for (H, C), n, m in shapes("K12"):
        def fold():
            return randint8((9 * C, C), -8, 7), (randf((C,), 2e-5, 2e-4).abs(), randf((C,), 0.1))

        (g1, sb1), (g2, sb2) = fold(), fold()
        r = randf((batch, H, H, C), 1.5, 0.2).to(torch.bfloat16)
        args = (r, randf((batch, C)), randf((C,), 0.1, 1.0), randf((C,), 0.1), quant(C, -0.5, 4.0), g1, sb1,
                randf((C,), 0.1, 1.0), randf((C,), 0.1), quant(C, -0.5, 3.0), g2, sb2)
        kt = dict(g1_t=k_major(g1), g2_t=k_major(g2))  # as the serving path calls it
        f = _held("K12", f"H={H} C={C}", resblock_pallas(*args, **kt), resblock_pallas(*args, plain=True))
        ms = time_ms(lambda: resblock_pallas(*args, **kt))
        dms = device_ms(lambda: resblock_pallas(*args, **kt))
        pms = time_ms(lambda: resblock_pallas(*args, plain=True), reps=10)
        # residual in and out, both folds; two int8 convs, the entry's 16 and the epilogue's 18 f32 per element
        b = bound(2 * nbytes(r) + nbytes(g1, g2) + 4 * batch * C + 12 * 4 * C,
                  int8_ops=2 * 2 * r.numel() * 9 * C, f32_flops=(16 + 18 + 3) * r.numel())
        report.add("K12", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K12 resblock_pallas B={batch} H={H} C={C} x{n}/step (resblock_pallas=all alone x{m}): "
              f"{_fig(f)}; kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        del r, args, g1, g2, kt
    torch.cuda.empty_cache()


def attention_kernel_phase(cfg, batch, gen, dev, report):
    """K10, K9, K8, K11 and K3's int8 core against their plain versions at
    every shape one serving step gives them under the three attention
    settings, weighted by the launches of the step that runs them."""
    import torch
    import torch.nn.functional as F

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.attention import flash_attention
    from attentiondm_tpu_torch.ops.int8_attention import (
        fused_attention_block,
        fused_int8_attention,
        fused_int8_attention_static,
    )
    from attentiondm_tpu_torch.ops.precision import exact_f32

    plans = {name: checks.attention_plan(cfg, **flags) for name, flags in ATTN_SETTINGS.items()}
    for name, plan in plans.items():
        print(f"[kernels] attention cores of a step, {name}: "
              + ", ".join(f"{k} x{len(v)} {sorted(set(v))}" for k, v in plan.items() if v))

    def randint8(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    def out_quant(C):  # proj_out's input quantization: 8 bits over about [-2, 2], integral zero points
        return torch.full((C,), 255 / 4.0, device=dev), randf((C,), 3.0).round()

    def run(kind, label, n, fn, b, library=None):
        got = fn()
        f = _held("K3" if kind == "K3.int8_core" else kind, label, got, fn(plain=True))
        del got
        ms = time_ms(fn)
        dms = device_ms(fn)
        pms = time_ms(lambda: fn(plain=True), reps=5)
        lib, lib_fig = None, ""
        if library is not None:
            lib = time_ms(library, reps=10)
            lib_fig = f" F.scaled_dot_product_attention {lib:.4f} ms"
        report.add(kind, f["max_abs_err"], ms, pms, b, weight=n, library_ms=lib, dev_ms=dms)
        print(f"[kernels] {kind} {label} x{n}/step: {_fig(f)}; kernel {ms:.4f} ms device {dms:.4f} ms "
              f"plain {pms:.4f} ms{lib_fig} {_bound_fig(b)}")
        torch.cuda.empty_cache()

    # K10 and K9: int8 q, k, v at scalar scales of absmax 2.4 / 127 (logits of a few units), sv 0.02
    static = plans["static int8"]
    for kind in ("K10", "K9"):
        for (L, C), n in sorted(collections.Counter(static[kind]).items()):
            q8, k8, v8 = (randint8((batch, L, C), -127, 127) for _ in range(3))
            sq, sk, sv = (torch.tensor(x, device=dev) for x in (0.019, 0.021, 0.02))
            osc, ozp = out_quant(C)
            b = bound(4 * q8.numel() + 8 * C + 12, int8_ops=2 * batch * L * L * C, bf16_flops=2 * batch * L * L * C,
                      f32_flops=5 * batch * L * L)
            run(kind, f"B={batch} L={L} C={C}", n, lambda plain=False: fused_int8_attention_static(
                q8, k8, v8, sq, sk, sv, osc, ozp, 8, scale=C ** -0.5, plain=plain), b)
            del q8, k8, v8
    # K8: int32 projection accumulators that dequantize to a few units
    for (L, C), n in sorted(collections.Counter(plans["dynamic int8"]["K8"]).items()):
        dots = [torch.randint(-20000, 20000, (batch, L, C), generator=gen, dtype=torch.int32).to(dev) for _ in range(3)]
        epis = [(randf((C,), 2e-5, 1e-4).abs(), randf((C,), 0.2)) for _ in range(3)]
        osc, ozp = out_quant(C)
        b = bound(13 * dots[0].numel() + 8 * 4 * C, int8_ops=2 * batch * L * L * C, bf16_flops=2 * batch * L * L * C,
                  f32_flops=5 * batch * L * L + 3 * 4 * dots[0].numel())
        run("K8", f"B={batch} L={L} C={C}", n, lambda plain=False: fused_int8_attention(
            *dots, *epis, osc, ozp, 8, scale=C ** -0.5, plain=plain), b)
        del dots
    # K11: f32 q, k, v; F.scaled_dot_product_attention computes the same function (its result is printed, not held)
    for (L, D), n in sorted(collections.Counter(plans["f32 core"]["K11"]).items()):
        q, k, v = (randf((batch, L, D)) for _ in range(3))
        with exact_f32():
            lib_out = F.scaled_dot_product_attention(q, k, v, scale=D ** -0.5)
            lib_err = (lib_out - flash_attention(q, k, v)).abs().max().item()
            del lib_out
            b = bound(4 * 4 * q.numel(), f32_flops=4 * batch * L * L * D + 5 * batch * L * L)
            run("K11", f"B={batch} L={L} D={D}", n, lambda plain=False: flash_attention(q, k, v, plain=plain), b,
                library=lambda: F.scaled_dot_product_attention(q, k, v, scale=D ** -0.5))
        print(f"[kernels] K11 B={batch} L={L} D={D}: max abs difference from F.scaled_dot_product_attention "
              f"{lib_err:.3e} (information only)")
        del q, k, v
    # K3 with the int8 core, at the shapes of kernel_phase's K3 check
    for (L, C), n in sorted(collections.Counter(static["K3.int8_core"]).items()):
        x = randf((batch, L, C)).to(torch.bfloat16)
        qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b_) for b_ in (8, 6, 8)]
        qkv_weights = [weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 2e-4).abs(), randf((C,), 0.1))
                       for _ in range(3)]
        o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
        o_weights = weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 1e-3).abs(), randf((C,), 0.1))
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant, qkv_weights, o_quant, o_weights)
        # as K3's bound, with q k^T in int8
        b = bound(2 * nbytes(x) + 4 * C * C + 16 * 4 * C, int8_ops=4 * 2 * batch * L * C * C + 2 * batch * L * L * C,
                  tf32x3_flops=2 * batch * L * L * C, f32_flops=30 * x.numel() + 5 * batch * L * L)
        run("K3.int8_core", f"fused_attention_block(int8_core) B={batch} L={L} C={C}", n,
            lambda plain=False: fused_attention_block(*args, scale=C ** -0.5, int8_core=True, plain=plain), b)
        ms32 = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        print(f"[kernels] K3 B={batch} L={L} C={C}: the f32 core on the same inputs {ms32:.4f} ms")
        del x, args
    torch.cuda.empty_cache()


def clock(what, fn, tag="slice"):
    """Run fn between synchronizations and print its host-clock seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"[{tag}] {what}: {time.perf_counter() - t0:.2f} s")
    return out


# `--profile`: (label, run, wall ms) of each sampler, profiled after every phase has run, so that no timed
# run has a profiler window before it
DEFERRED_PROFILES = []


def profile_sampler(label, run, wall_ms, top: int = 25):
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
    print(f"[profile] {label}: device kernel time {total:.1f} ms over one sampler run of {wall_ms:.1f} ms wall "
          f"(timed without the profiler)")
    for ms, n, key in rows[:top]:
        print(f"[profile] {ms:9.2f} ms {n:6d}x {ms / total * 100:5.1f}% {key[:100]}")


def slice_phase(cfg, sched, label, steps, batch, gen, dev, profile=False, settings=None):
    """Drive the path's sampler through the kernels, once per attention
    setting ({name: flags}; default: the f32 core alone); returns the launch
    counts of each setting's counted run, and the context of the last one."""
    import torch

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, make_timestep_seq
    from attentiondm_tpu_torch.models.unet import count_params, unet_apply, unet_init
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.attention import flash_attention
    from attentiondm_tpu_torch.quant.calibrate import calibrate_ranges
    from attentiondm_tpu_torch.quant.int8_serving import (
        prepare_serving_runtime,
        runtime_nbytes,
        serving_ddim_sampler,
    )
    from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

    settings = settings or {"f32 core": F32_CORE}
    R, shape = cfg.resolution, (batch, cfg.resolution, cfg.resolution, cfg.out_ch)
    params = unet_init(gen, cfg, dev)
    print(f"[slice] {label}: {R}^2, {count_params(params) / 1e6:.2f}M params, W4A8, {steps} quad steps, "
          f"batch {batch}")
    betas = sched.betas.to(dev)
    seq = make_timestep_seq(1000, steps, "quad")
    x_small = torch.randn((2, R, R, cfg.in_channels), generator=gen).to(dev)
    checks.reset_launches()
    _, traj, _ = clock("FP teacher trajectory (2 images)", lambda: ddim_sample(
        lambda xt, t, i: unet_apply(params, cfg, xt, t), x_small, seq, betas, keep_trajectory=True))
    k11_sites = len(checks.attention_plan(cfg, **F32_CORE)["K11"])  # the FP UNet's long maps are the serving path's
    if flash_attention.launches != steps * k11_sites:
        raise AssertionError(f"FP teacher: K11 launched {flash_attention.launches} times, expected {steps * k11_sites}")
    if k11_sites:
        print(f"[slice] FP teacher: K11 launched {flash_attention.launches} times ({k11_sites} sites a forward)")
    xs_in = torch.cat([x_small[None], traj[:-1]])
    qunet = QuantizedUNet.create(cfg, 4, 8)
    qstates, attn_ranges = clock("stage-1 calibration", lambda: calibrate_ranges(
        qunet, params, qunet.init_state(steps, dev), xs_in, seq, return_attn_ranges=True))
    del traj, xs_in
    runtime = clock("per-step fold", lambda: prepare_serving_runtime(qunet, params, qstates))
    kmajor = sum(lay.gqt.numel() for lay in runtime.values())
    print(f"[slice] fold size: {runtime_nbytes(runtime) / 1e9:.3f} GB for {steps} steps, {kmajor / 1e9:.3f} GB of it "
          f"the weights' K-major copies; attention ranges of {len(attn_ranges)} projections")
    x = torch.randn(shape, generator=gen).to(dev)
    ctx = dict(cfg=cfg, params=params, qunet=qunet, qstates=qstates, runtime=runtime, seq=seq, betas=betas,
               x=x, steps=steps, batch=batch, dev=dev)

    counts, outs = {}, {}
    for name, flags in settings.items():
        if flags.get("attn_ranges"):
            flags = {**flags, "attn_ranges": attn_ranges}
        sample = serving_ddim_sampler(qunet, params, qstates, seq, betas, runtime=runtime, **flags)
        # the main path, counted
        expected = checks.expected_launches(cfg, steps, batch, **flags)
        checks.reset_launches()
        out = clock(f"serving sampler, {name}, first run ({steps} steps, batch {batch})", lambda: sample(x))
        counts[name] = checks.read_launches()
        print(f"[slice] {name}: launches {counts[name]}, expected {expected}")
        if counts[name] != expected:
            raise AssertionError(f"{name}: launch counts {counts[name]} != expected {expected}")
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"sampler output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
        outs[name] = out

        best = min(time_ms(lambda: sample(x), reps=1) for _ in range(2))
        print(f"[slice] serving sampler, {name}: {best:.1f} ms for {steps} steps at batch {batch} = "
              f"{batch / best * 1e3:.2f} images/s ({best / steps:.2f} ms/step; information only); "
              f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
        if profile:
            DEFERRED_PROFILES.append((f"{label}, {name}", lambda sample=sample: sample(x), best))
        step_checks(ctx, flags)
    ref = outs.get("f32 core")
    for name, out in outs.items():
        if ref is not None and out is not ref:
            print(f"[slice] sampler output, {name} vs f32 core: mean rel difference "
                  f"{((out - ref).abs().mean() / ref.abs().mean()).item():.3e} (information only; random weights)")
    return counts, ctx


def step_checks(ctx, levers, tag="slice"):
    """One serving step under `levers` (and attention flags): every kernel call held against its
    plain version on the same inputs, then the whole step through the kernels
    against the whole step through the plain versions.  Returns the step's
    launch counts."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_serving import serving_unet_apply

    t0 = torch.full((ctx["batch"],), float(ctx["seq"][-1]), device=ctx["dev"])

    def step(plain):
        return serving_unet_apply(ctx["params"], ctx["cfg"], ctx["qunet"], ctx["runtime"], ctx["qstates"],
                                  ctx["x"], t0, 0, plain=plain, **levers)

    records = []
    checks.reset_launches()
    with checks.per_site(records):
        eps = clock("one serving step, per-site check", lambda: step(False), tag)
    counts = checks.read_launches()
    by_kind = collections.defaultdict(list)
    for kind, oshape, f in records:
        by_kind[kind].append((oshape, f))
    for kind, rows in by_kind.items():
        worst = max(rows, key=lambda r: (not r[1]["ok"], r[1]["max_abs_err"]))
        print(f"[{tag}] per-site {kind}: {len(rows)} sites, {sum(r[1]['ok'] for r in rows)} within tolerance; "
              f"worst {worst[0]}: {_fig(worst[1])}")
    bad = [r for r in records if not r[2]["ok"]]
    if bad:
        raise AssertionError(f"per-site kernels vs plain: {len(bad)} sites off tolerance: {bad[:5]}")

    # the same step, chained: through the kernels vs through the plain versions
    eps_p = step(True)
    rel = ((eps - eps_p).abs().mean() / eps_p.abs().mean()).item()
    print(f"[{tag}] one serving step chained, kernels vs plain versions: mean rel err {rel:.3e} "
          f"(bit-identical: {torch.equal(eps, eps_p)}; gross-fault bound {CHAINED_BOUND})")
    if not rel < CHAINED_BOUND:
        raise AssertionError(f"serving step kernels vs plain: mean rel err {rel}")
    return counts


def levers_phase(ctx, timed, profile=False):
    """The same params, calibration and fold under the three levers.  With
    `timed` (CIFAR-10): the sampler with all three, counted and checked, the
    per-site and chained step, and timed runs in turns of levers off, all
    three and each lever alone.  Without (church): the per-site and chained
    step, launch counts checked.  Returns the counted run's launch counts."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg, steps, batch, x = ctx["cfg"], ctx["steps"], ctx["batch"], ctx["x"]
    plan = checks.lever_plan(cfg, batch, **ALL_LEVERS)
    print(f"[levers] {ALL_LEVERS}: per step K4 at {len(plan['K4'])} entries, K7 at "
          f"{[site for site, *_ in plan['K7']]}, K12 at {[site for site, *_ in plan['K12']]}")
    if not timed:
        expected = checks.expected_launches(cfg, 1, batch, **F32_CORE, **ALL_LEVERS)
        counts = step_checks(ctx, {**F32_CORE, **ALL_LEVERS}, "levers")
        print(f"[levers] launches of the step {counts}, expected {expected}")
        if counts != expected:
            raise AssertionError(f"lever step launch counts {counts} != expected {expected}")
        return counts

    def sampler(levers):
        return serving_ddim_sampler(ctx["qunet"], ctx["params"], ctx["qstates"], ctx["seq"], ctx["betas"],
                                    runtime=ctx["runtime"], **F32_CORE, **levers)

    sample = sampler(ALL_LEVERS)
    expected = checks.expected_launches(cfg, steps, batch, **F32_CORE, **ALL_LEVERS)
    checks.reset_launches()
    out = clock(f"serving sampler with the three levers, first run ({steps} steps, batch {batch})",
                lambda: sample(x), "levers")
    counts = checks.read_launches()
    print(f"[levers] launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"lever launch counts {counts} != expected {expected}")
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"lever sampler output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    off = sampler({})(x)
    rel = ((out - off).abs().mean() / off.abs().mean()).item()
    print(f"[levers] sampler output, three levers vs levers off: mean rel err {rel:.3e} (information only: the "
          f"levers change the GroupNorm statistics' formula and where bf16 rounds)")
    del out, off

    step_checks(ctx, {**F32_CORE, **ALL_LEVERS}, "levers")

    # timed runs in turns (levers off, all three, each lever alone), LEVER_ROUNDS rounds: the host's ~1000
    # launches a step set these times as much as the card does, and the host's clock varies, so every run is shown
    fns = {name: sampler(levers) for name, levers in [("levers off", {}), *LEVER_SETS.items()]}
    for fn in fns.values():
        fn(x)  # warm-up
    runs = {name: [] for name in fns}
    for _ in range(LEVER_ROUNDS):
        for name, fn in fns.items():
            runs[name].append(time_ms(lambda: fn(x), reps=1, warm=False))
    times = {}
    for name, levers in [("levers off", {}), *LEVER_SETS.items()]:
        ms = times[name] = sorted(runs[name])[LEVER_ROUNDS // 2]
        per = checks.expected_launches(cfg, 1, batch, **F32_CORE, **levers)
        print(f"[levers] serving sampler, {name}: median {ms:.1f} ms for {steps} steps at batch {batch} = "
              f"{batch / ms * 1e3:.2f} images/s ({ms / steps:.2f} ms/step; best {min(runs[name]):.1f} ms; runs "
              f"{' '.join(f'{t:.1f}' for t in runs[name])}; launches per step "
              f"K1 {per['K1']} K2 {per['K2']} K3 {per['K3']} K4 {per['K4']} K7 {per['K7']} K12 {per['K12']})")
    if profile:
        DEFERRED_PROFILES.append((f"batch {batch}, the three levers", lambda: sample(x), times["all three"]))
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler's device time per kernel for one sampler run")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the GPU")
    from attentiondm_tpu_torch.ops import _build

    card = nvidia_smi_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    so, seconds = _build.build()
    _build.kernels()
    print(f"[build] {so.name}: {seconds:.1f} s (nvcc, sm_90a)")

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    kernels = []
    for path in BATCH:
        t0 = time.perf_counter()
        cfg, sched, label = path_config(path)
        steps = min(args.steps, MAX_STEPS.get(path, args.steps))
        print(f"== {path}: {label}, batch {BATCH[path]}")
        report = Report()
        if path == "celeba-wide":
            attention_kernel_phase(cfg, BATCH[path], gen, dev, report)
            epilogue_phase(cfg, BATCH[path], gen, dev, report)
            counts, ctx = slice_phase(cfg, sched, label, steps, BATCH[path], gen, dev, args.profile, ATTN_SETTINGS)
            launches_of = {**{key: counts[run][key] for key, run in ATTN_RUN.items()},
                           "K2": counts["static int8"]["K2"]}
        else:
            kernel_phase(cfg, BATCH[path], gen, dev, report)
            counts, ctx = slice_phase(cfg, sched, label, steps, BATCH[path], gen, dev, args.profile)
            lever_counts = levers_phase(ctx, timed=path == "cifar10", profile=args.profile)
            launches_of = {**counts["f32 core"], **{key: lever_counts[key] for key in ("K4", "K7", "K12")},
                           "K3.core": counts["f32 core"]["K3"]}
        del ctx
        for key, (name, source, replaces) in META.items():
            if key not in report.rows:
                continue
            r = report.rows[key]
            launches = launches_of[key]
            kernels.append({"name": f"{key} {name}", "path": path, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
                            "ms": round(r["ms"], 4), "device_ms": round(r["device_ms"], 4),
                            "plain_ms": round(r["plain_ms"], 4),
                            "bound_ms": round(r["bound_ms"], 4),
                            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
                            "library_ms": None if r["library_ms"] is None else round(r["library_ms"], 4)})
            if launches == 0:
                raise AssertionError(f"{key} was not launched on the {path} path")
        torch.cuda.empty_cache()
        print(f"== {path}: {time.perf_counter() - t0:.1f} s")
    for label, run, wall_ms in DEFERRED_PROFILES:
        profile_sampler(label, run, wall_ms)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
