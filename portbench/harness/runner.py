"""One run of one cell: set-up, the measured window (or the traced calls),
the metrics, the comparison with the reference, and the result line."""
from __future__ import annotations

import argparse
import gc
import json
import math
import random
import subprocess
import sys
import time

import torch

from . import check, params, program, trace
from .registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "attentiondm_tpu")  # top-level modules that may not be loaded
STREAM_WEIGHTS, STREAM_CALIBRATION, STREAM_WARMUP, STREAM_CALLS = 0, 1, 2, 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (so `attentiondm_tpu_torch` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Record:
    """What the metric readers read."""

    def __init__(self):
        self.calls, self.setup_s, self.window_peak_bytes = [], None, None
        self.seconds, self.trace, self.work = {}, None, None


def closed_loop(sample, make_input, seconds):
    """Back-to-back calls on fresh noise, each ended by its output's copy to
    the host (which waits for the device), until `seconds` have passed;
    returns [(start, end, images)] and the host outputs."""
    calls, outs = [], []
    first = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        x = make_input(i)
        out = sample(x).cpu()
        t1 = time.perf_counter()
        calls.append((t0, t1, x.shape[0]))
        outs.append(out)
        i += 1
        if t1 - first >= seconds:
            return calls, outs


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def inputs(cfg, mix, ref, seed, dev):
    """(weights, calibration images, make_input(stream) -> a call's noise),
    every draw on `dev` from its own stream of the seed."""
    p = params.draw_params(ref.param_layout(cfg), params.seeded(seed, STREAM_WEIGHTS, dev), dev)
    res, chans = cfg["data"]["image_size"], cfg["model"]["in_channels"]
    x_cal = torch.randn((cfg["quant"]["calibration_images"], res, res, chans),
                        generator=params.seeded(seed, STREAM_CALIBRATION, dev), device=dev)

    def make_input(stream):
        return torch.randn((mix["batch"], res, res, chans), generator=params.seeded(seed, stream, dev), device=dev)

    return p, x_cal, make_input


def execute(reg: Registry, cell: str, seed: int, seconds: float, trace_on: bool, device, t_start: float,
            wrap_sampler=None) -> dict:
    """Run `cell` on `device` and return the result (the last line's keys and
    `checks`).  `wrap_sampler(sample) -> sample` plants a fault (tests).  On a
    CPU device nothing is measured: the metrics stay empty."""
    w = reg.cell(cell)
    cfg, mix, limits = reg.config(w["config"]), reg.traffic(w["traffic"]), reg.limits(cell)
    ref = reg.reference(cfg)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    prog = program.Program(cfg, mix, dev)

    p, x_cal, make_input = inputs(cfg, mix, ref, seed, dev)
    xs_in = prog.teacher(p, x_cal)
    qstates = prog.calibrate(p, xs_in)
    sample = prog.sampler(p, qstates)
    runtime = sample.runtime
    if wrap_sampler is not None:
        sample = wrap_sampler(sample)
    batch = mix["batch"]
    t0 = time.perf_counter()
    sample(make_input(STREAM_WARMUP)).cpu()
    prog.seconds["warmup_s"] = time.perf_counter() - t0
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way: no full collection scans them in the window
    rec = Record()
    rec.setup_s = time.perf_counter() - t_start
    rec.seconds = prog.seconds
    log("[portbench] set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in prog.seconds.items())
        + f", setup_s {rec.setup_s:.3f}")
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def call(i):
        return sample(make_input(STREAM_CALLS + i)).cpu()

    if trace_on:
        outs = []

        def run_calls():
            for i in range(mix["trace_calls"]):
                with torch.profiler.record_function("portbench.call"):
                    outs.append(call(i))

        if on_card:
            with program.Spans():
                rec.trace = trace.profile_calls(run_calls)
        else:
            run_calls()
    else:
        rec.calls, outs = closed_loop(sample, lambda i: make_input(STREAM_CALLS + i), seconds)
        log("[portbench] calls (s): " + " ".join(f"{e - s:.4f}" for s, e, _n in rec.calls))
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rec.window_peak_bytes = window_peak if on_card else None
    log(f"[portbench] peak device memory: window {window_peak} B, set-up {setup_peak} B")
    rec.work = reg.roofline(cfg).step_work(cfg, batch, residual_bytes=4 if mix["sampler_flags"].get(
        "residual_dtype", "float32") == "float32" else 2, dot_bf16=mix["sampler_flags"].get("dot_bf16", True))

    metrics = {}
    if on_card:
        for m in reg.metrics(cell, trace_on):
            v = reg.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the comparison: one call of the window drawn from the seed, every image of it, and each of its blocks
    # from a replay of that call on the same noise
    pick = random.Random(seed).randrange(len(outs))
    x_pick = make_input(STREAM_CALLS + pick)
    ranges = program.Program.ranges(qstates)
    t0 = time.perf_counter()
    blocks = check.BlockCheck(ref, cfg, p, ranges, ref.schedule(cfg, mix["timesteps"], mix["skip_type"], dev))
    with program.Blocks(blocks):
        again = sample(x_pick).cpu()
    blocks.folds = None
    log(f"[portbench] replay of call {pick} with the block check: {time.perf_counter() - t0:.1f} s, max "
        f"|difference| from the window's output {float((again - outs[pick]).abs().max()):.3g}")
    subject = check.Subject(xs_in, ranges, lambda name, s, shape: program.Program.fold_step(runtime, name, s, shape),
                            outs[pick], blocks.gaps)

    def free_program():
        nonlocal sample, runtime
        subject.fold = None
        sample = runtime = None
        if on_card:
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    verdict = check.judge(ref, cfg, mix, limits, p, x_cal, x_pick, subject, log,
                          release=free_program)
    log(f"[portbench] reference check: {time.perf_counter() - t0:.1f} s, call {pick} of {len(outs)}, "
        f"{verdict['images']} images")

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": verdict["correct"], "attempted": len(outs) * batch, "failed": verdict["failed"],
              "metrics": metrics, "device": device_info}
    if trace_on and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s()
        device_info["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["numbers"].items()}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py", description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    ap.add_argument("--seed", type=int, required=True, help="any whole number: weights, images and noise")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="0: the end-to-end metrics; 1: the per-layer metrics from a profiled run")
    args = ap.parse_args(argv)
    if not args.seconds > 0 or not math.isfinite(args.seconds):
        ap.error(f"--seconds {args.seconds}: a positive number")
    return args


def main(argv, t_start: float) -> int:
    args = parse(argv)
    reg = Registry()
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[portbench] {args.workload} needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    log(f"[portbench] card: {card_line()}")
    result = execute(reg, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        log(f"[portbench] loaded in this process: {', '.join(found)} (JAX or the JAX package): no result")
        return 3
    for name, c in result["checks"].items():
        log(f"[portbench] check {name} {c['value']:.6g} limit {c['limit']:.6g}")
    print(json.dumps(result), flush=True)
    return 0
