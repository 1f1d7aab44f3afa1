#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`attentiondm_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--steps 10] [--seed 0] [--profile]

1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the CUDA kernels from attentiondm_tpu_torch/csrc/;
3. then each path in turn, the CIFAR-10 W4A8 sampler (`UNetConfig()`,
   batch 128) and the LSUN church W4A8 sampler (`configs/church.yml`,
   256^2, batch 32):
   a. kernels: each kernel against its plain PyTorch version on the card at
      every distinct shape the path's serving step gives it
      (`ops.checks.conv_plan`), held to its tolerance (`ops.checks.compare`),
      with times (CUDA events, median of 20 launches, 10 for the plain
      version): K1 at every int8 conv shape (its int32 mode at the 3x3
      shapes is K13's check, its 1x1 mode at the shortcut shapes K5's), K2
      and K6 at every resblock epilogue shape as the router sends them, K3
      at every attention shape.  At K6's shapes K2 is also run and timed
      against K6.  A kernel's `ms` / `plain_ms` in the JSON line is the sum
      over one serving step's launches of it;
   b. slice: the full-width UNet at W4A8 with seeded random weights: FP DDIM
      teacher trajectory on 2 images, stage-1 calibration, the per-step fold
      and the int8 serving DDIM sampler (--steps quad steps; --steps 100 is
      bench.py's schedule).  Checks the output's shape and finiteness and
      each kernel's launch count against `ops.checks.expected_launches`;
      then one serving step teacher-forced, every kernel call held to its
      tolerance against its plain version on the same inputs
      (`ops.checks.per_site`), and the whole step through the kernels
      against the whole step through the plain versions (printed, held to a
      gross-fault bound).
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
BATCH = {"cifar10": 128, "church": 32}

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
}


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def path_config(path):
    """(UNetConfig, DiffusionSchedule, label) of a path: CIFAR-10's default
    config, or the church model loaded from the repository's church.yml."""
    from attentiondm_tpu_torch.config import load_config
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import UNetConfig

    if path == "cifar10":
        return UNetConfig(), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000), "UNetConfig() CIFAR-10"
    config = load_config("church.yml")
    return (UNetConfig.from_config(config), DiffusionSchedule.from_config(config),
            "church.yml LSUN church_outdoor")


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
    """Per-kernel error and time, summed over one serving step's launches."""

    def __init__(self):
        self.rows = {}

    def add(self, key, err, ms, plain_ms, weight=1):
        r = self.rows.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += weight * ms
        r["plain_ms"] += weight * plain_ms


def _fig(f) -> str:
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in f.items())


def _held(kind, label, got, want):
    from attentiondm_tpu_torch.ops import checks

    f = checks.compare(kind, got, want)
    if not f["ok"]:
        raise AssertionError(f"{kind} {label}: {f}")
    return f


def kernel_phase(cfg, batch, gen, dev, report):
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.fused_gn import epilogue_gn_swish_quant, epilogue_gn_swish_quant_whole
    from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
    from attentiondm_tpu_torch.ops.pallas_conv import int8_conv

    k1, k2, k6, k3 = checks.conv_plan(cfg)

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
        f = _held("K1", f"H={H} Cp={Cp} Np={Np} k={k} s={s} {mode}", int8_conv(*args, **kw),
                  int8_conv(*args, **kw, plain=True))
        ms = time_ms(lambda: int8_conv(*args, **kw))
        pms = time_ms(lambda: int8_conv(*args, **kw, plain=True), reps=10)
        report.add(key, f["max_abs_err"], ms, pms, weight=n)
        print(f"[kernels] {key} int8_conv B={batch} H={H} Cp={Cp} Np={Np} k={k} s={s} "
              f"{str(mode).removeprefix('torch.')} x{n}/step: {_fig(f)}; kernel {ms:.4f} ms plain {pms:.4f} ms")
        del xp, gq, args

    # K2 and K6: bf16 conv1 output (identity epilogue) at every resblock shape, as
    # the router sends it; the first channel group sits at a large offset (mean 40),
    # where float32 E[x^2] - mu^2 cancels.  At K6's shapes K2 runs too, for its time.
    for kind, shapes in (("K2", k2), ("K6", k6)):
        for (HW, N), n in sorted(collections.Counter(shapes).items()):
            H = int(HW ** 0.5)
            dot = randf((batch, H, H, N), 2.0, 0.3).to(torch.bfloat16)
            zcbias = torch.zeros(N, device=dev)
            zcbias[:N // 32] = 40.0
            args = (dot, torch.ones(N, device=dev), zcbias, randf((batch, N)), randf((N,), 0.1, 1.0),
                    randf((N,), 0.1), torch.full((N,), 255 / 4.5, device=dev),
                    torch.full((N,), round(255 / 4.5 * -0.5) + 128.0, device=dev), 8)
            f = _held(kind, f"HW={HW} N={N}", epilogue_gn_swish_quant(*args),
                      epilogue_gn_swish_quant(*args, plain=True))
            ms = time_ms(lambda: epilogue_gn_swish_quant(*args))
            pms = time_ms(lambda: epilogue_gn_swish_quant(*args, plain=True), reps=10)
            report.add(kind, f["max_abs_err"], ms, pms, weight=n)
            print(f"[kernels] {kind} epilogue_gn_swish_quant B={batch} HW={HW} N={N} x{n}/step: {_fig(f)}; "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms")
            if kind == "K6":
                f2 = _held("K2", f"HW={HW} N={N} (at K6's shape)", epilogue_gn_swish_quant_whole(*args),
                           epilogue_gn_swish_quant_whole(*args, plain=True))
                ms2 = time_ms(lambda: epilogue_gn_swish_quant_whole(*args))
                print(f"[kernels] K6 vs K2 B={batch} HW={HW} N={N}: K6 {ms:.4f} ms, K2 {ms2:.4f} ms "
                      f"({_fig(f2)}), K6's plain version {pms:.4f} ms")
            del dot, args

    # K3: every attention shape (the k projection at a_bit 6, as the W4A8 policy)
    for (L, C), n in sorted(collections.Counter(k3).items()):
        x = randf((batch, L, C)).to(torch.bfloat16)
        qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b) for b in (8, 6, 8)]
        qkv_weights = [(randint8((C, C), -8, 7), randf((C,), 1e-5, 2e-4).abs(), randf((C,), 0.1))
                       for _ in range(3)]
        o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
        o_weights = (randint8((C, C), -8, 7), randf((C,), 1e-5, 1e-3).abs(), randf((C,), 0.1))
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant, qkv_weights, o_quant, o_weights)
        f = _held("K3", f"L={L} C={C}", fused_attention_block(*args, scale=C ** -0.5),
                  fused_attention_block(*args, scale=C ** -0.5, plain=True))
        ms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        pms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5, plain=True), reps=10)
        report.add("K3", f["max_abs_err"], ms, pms, weight=n)
        print(f"[kernels] K3 fused_attention_block B={batch} L={L} C={C} x{n}/step: {_fig(f)}; "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms")
    torch.cuda.empty_cache()


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
        print(f"[profile] {ms:9.2f} ms {n:6d}x {ms / total * 100:5.1f}% {key[:100]}")


def slice_phase(cfg, sched, label, steps, batch, gen, dev, profile=False):
    """Drive the path's sampler once through the kernels; returns the launch counts."""
    import torch

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, make_timestep_seq
    from attentiondm_tpu_torch.models.unet import count_params, unet_apply, unet_init
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.calibrate import calibrate_ranges
    from attentiondm_tpu_torch.quant.int8_serving import (
        prepare_serving_runtime,
        runtime_nbytes,
        serving_ddim_sampler,
        serving_unet_apply,
    )
    from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

    def clock(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"[slice] {what}: {time.perf_counter() - t0:.2f} s")
        return out

    R, shape = cfg.resolution, (batch, cfg.resolution, cfg.resolution, cfg.out_ch)
    params = unet_init(gen, cfg, dev)
    print(f"[slice] {label}: {R}^2, {count_params(params) / 1e6:.2f}M params, W4A8, {steps} quad steps, "
          f"batch {batch}")
    betas = sched.betas.to(dev)
    seq = make_timestep_seq(1000, steps, "quad")
    x_small = torch.randn((2, R, R, cfg.in_channels), generator=gen).to(dev)
    _, traj, _ = clock("FP teacher trajectory (2 images)", lambda: ddim_sample(
        lambda xt, t, i: unet_apply(params, cfg, xt, t), x_small, seq, betas, keep_trajectory=True))
    xs_in = torch.cat([x_small[None], traj[:-1]])
    qunet = QuantizedUNet.create(cfg, 4, 8)
    qstates = clock("stage-1 calibration", lambda: calibrate_ranges(
        qunet, params, qunet.init_state(steps, dev), xs_in, seq))
    del traj, xs_in
    runtime = clock("per-step fold", lambda: prepare_serving_runtime(qunet, params, qstates))
    print(f"[slice] fold size: {runtime_nbytes(runtime) / 1e9:.3f} GB for {steps} steps")
    sample = serving_ddim_sampler(qunet, params, qstates, seq, betas, runtime=runtime)
    x = torch.randn(shape, generator=gen).to(dev)

    # the main path, counted
    expected = checks.expected_launches(cfg, steps)
    checks.reset_launches()
    out = clock(f"serving sampler, first run ({steps} steps, batch {batch})", lambda: sample(x))
    counts = checks.read_launches()
    print(f"[slice] launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sampler output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    del out

    best = min(time_ms(lambda: sample(x), reps=1) for _ in range(2))
    print(f"[slice] serving sampler: {best:.1f} ms for {steps} steps at batch {batch} = "
          f"{batch / best * 1e3:.2f} images/s ({best / steps:.2f} ms/step; information only); "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    if profile:
        profile_sampler(lambda: sample(x), best)

    # one serving step, every kernel call held against its plain version on the same inputs
    t0 = torch.full((batch,), float(seq[-1]), device=dev)

    def step(plain):
        return serving_unet_apply(params, cfg, qunet, runtime, qstates, x, t0, 0, plain=plain)

    records = []
    with checks.per_site(records):
        eps = clock("one serving step, per-site check", lambda: step(False))
    by_kind = collections.defaultdict(list)
    for kind, oshape, f in records:
        by_kind[kind].append((oshape, f))
    for kind, rows in by_kind.items():
        worst = max(rows, key=lambda r: (not r[1]["ok"], r[1]["max_abs_err"]))
        print(f"[slice] per-site {kind}: {len(rows)} sites, {sum(r[1]['ok'] for r in rows)} within tolerance; "
              f"worst {worst[0]}: {_fig(worst[1])}")
    bad = [r for r in records if not r[2]["ok"]]
    if bad:
        raise AssertionError(f"per-site kernels vs plain: {len(bad)} sites off tolerance: {bad[:5]}")

    # the same step, chained: through the kernels vs through the plain versions
    eps_p = step(True)
    rel = ((eps - eps_p).abs().mean() / eps_p.abs().mean()).item()
    print(f"[slice] one serving step chained, kernels vs plain versions: mean rel err {rel:.3e} "
          f"(bit-identical: {torch.equal(eps, eps_p)}; gross-fault bound {CHAINED_BOUND})")
    if not rel < CHAINED_BOUND:
        raise AssertionError(f"serving step kernels vs plain: mean rel err {rel}")
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
        print(f"== {path}: {label}, batch {BATCH[path]}")
        report = Report()
        kernel_phase(cfg, BATCH[path], gen, dev, report)
        counts = slice_phase(cfg, sched, label, args.steps, BATCH[path], gen, dev, args.profile)
        for key in ("K1", "K13", "K5", "K2", "K6", "K3"):
            if key not in report.rows:
                continue
            name, source, replaces = META[key]
            r = report.rows[key]
            kernels.append({"name": f"{key} {name}", "path": path, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": counts[key], "max_abs_err": r["max_abs_err"],
                            "ms": round(r["ms"], 4), "plain_ms": round(r["plain_ms"], 4)})
            if counts[key] == 0:
                raise AssertionError(f"{key} was not launched on the {path} path")
        torch.cuda.empty_cache()
        print(f"== {path}: {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
