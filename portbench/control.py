"""Readings of the comparison that decides `correct`, for setting its limits.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --subjects program,bf16_stream,combined,tf32,a4 [--steps-only] [--device cuda:0]

For each seed it draws the cell's weights, calibration images and the noise
of one call, runs the reference's pipeline once, and judges each subject
against it as a run does (`harness/check.py`), printing one JSON line per
(seed, subject) with the five numbers and whether the cell's limits hold:

  program      the port at the cell's flags: the lower readings;
  bf16_stream  the port with its own bfloat16 residual stream, one step
               below the float32 stream the configuration states: the
               control of `block_gap` and `block_median`;
  tf32         the reference with TF32 on (one step below the float32
               products the configuration states);
  a4           the reference at 4-bit activations (one step below int8);
  combined     both at once: the control of the other three numbers.

The block numbers are read of the program's subjects alone.  `--blocks-only`
reads nothing else: no reference pipeline, one calibration a seed for both.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench.harness import check, program, runner  # noqa: E402
from portbench.harness.registry import Registry  # noqa: E402

SUBJECTS = {"tf32": ("tf32", None), "a4": ("f32", 4), "combined": ("tf32", 4)}  # (precision, a_bit)
PROGRAM = {"program": {}, "bf16_stream": {"residual_dtype": torch.bfloat16}}  # sampler overrides


def reference_subject(ref, cfg, params, x_cal, x_call, sched, mode, a_bit):
    c = {**cfg, "quant": {**cfg["quant"], "a_bit": a_bit}}
    xs, ranges, folds, images = check.reference_pipeline(ref, c, params, x_cal, x_call, sched, mode)
    return check.Subject(xs, ranges, lambda name, s, _shape: (folds[name]["codes"][s], folds[name]["inv_ws"][s],
                                                               folds[name]["zcbias"][s]), images, None)


def program_subject(ref, cfg, mix, params, x_cal, x_call, sched, dev, calibrated=None, **override):
    """The port's subject, its blocks checked as a run checks them;
    `calibrated` (prog, teacher, qstates) of an earlier subject of the same
    seed skips the teacher and stage 1."""
    if calibrated is None:
        prog = program.Program(cfg, mix, dev)
        xs = prog.teacher(params, x_cal)
        calibrated = prog, xs, prog.calibrate(params, xs)
    prog, xs, qstates = calibrated
    sample = prog.sampler(params, qstates, **override)
    ranges = program.Program.ranges(qstates)
    blocks = check.BlockCheck(ref, cfg, params, ranges, sched)
    with program.Blocks(blocks):
        images = sample(x_call)
    blocks.folds = None
    runtime = sample.runtime
    return check.Subject(xs, ranges, lambda name, s, shape: program.Program.fold_step(runtime, name, s, shape),
                         images, blocks.gaps), calibrated


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--subjects", default="program,bf16_stream")
    ap.add_argument("--blocks-only", action="store_true", help="the block numbers alone, of program and bf16_stream")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=ROOT, help="the checkout holding BENCHMARK.json")
    args = ap.parse_args(argv)
    reg = Registry(args.root)
    w = reg.cell(args.workload)
    cfg, mix, limits = reg.config(w["config"]), reg.traffic(w["traffic"]), reg.limits(args.workload)
    ref = reg.reference(cfg)
    dev = torch.device(args.device)
    subjects = args.subjects.split(",")
    unknown = [n for n in subjects if n not in PROGRAM and (args.blocks_only or n not in SUBJECTS)]
    if unknown:
        raise SystemExit(f"unknown subject(s) {unknown}: {', '.join(PROGRAM)}"
                         + ("" if args.blocks_only else f", {', '.join(SUBJECTS)}"))
    for seed in (int(s) for s in args.seeds.split(",")):
        params, x_cal, make_input = runner.inputs(cfg, mix, ref, seed, dev)
        x_call = make_input(runner.STREAM_CALLS)
        sched = ref.schedule(cfg, mix["timesteps"], mix["skip_type"], dev)
        t_ref, reference, calibrated = 0.0, None, None
        if not args.blocks_only:
            t0 = time.perf_counter()
            reference = check.reference_pipeline(ref, cfg, params, x_cal, x_call, sched)
            t_ref = time.perf_counter() - t0
        for name in subjects:
            t0 = time.perf_counter()
            if name in PROGRAM:
                subject, calibrated = program_subject(ref, cfg, mix, params, x_cal, x_call, sched, dev, calibrated,
                                                      **PROGRAM[name])
            else:
                mode, a_bit = SUBJECTS[name]
                subject = reference_subject(ref, cfg, params, x_cal, x_call, sched, mode,
                                            a_bit or cfg["quant"]["a_bit"])
            if args.blocks_only:
                g, med = check.block_gaps(subject.blocks)
                line = {"block_gap": g, "block_median": med, "blocks": len(subject.blocks),
                        "worst": max(subject.blocks, key=lambda b: b[2])[:2],
                        "correct": g <= limits["block_gap"] and med <= limits["block_median"]}
            else:
                verdict = check.judge(ref, cfg, mix, limits, params, x_cal, x_call, subject, runner.log,
                                      reference=reference)
                line = {"correct": verdict["correct"], "failed": verdict["failed"],
                        **{k: v for k, (v, _lim) in verdict["numbers"].items()}}
            print(json.dumps({"workload": args.workload, "seed": seed, "subject": name, **line,
                              "seconds": time.perf_counter() - t0, "reference_s": t_ref}), flush=True)
            del subject
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
