"""The comparison that decides `correct`.

Five numbers, each held to the cell's limit (`workloads/<cell>.json`):

  teacher_gap  the set-up's FP teacher trajectory (the port's `unet_apply`
               and DDIM update) against the reference's from the same
               weights and calibration images: max |difference| over max
               |reference| over every step's model input;
  fold_gap     the port's W4 fold against the reference's fold of the same
               group ranges, every folded conv at every step: the largest
               of the share of int4 codes that differ and the relative gaps
               (max |difference| over max |reference|) of 1 / weight scale
               and of the zero-point correction plus bias;
  block_gap    every resblock and attention block of every step of the
               sampled call (replayed on its noise), each on its own
               input: the port's output against the reference's block on
               the same input, over the port's own ranges and the
               reference's fold of them: mean |difference| over mean
               |reference| over the batch, the largest over blocks and
               steps;
  block_median the median of those gaps.  The two see a float precision
               step inside serving (a bfloat16 residual stream) that
               whole-step numbers cannot: int8 chains turn any rounding
               difference into quantization noise within a step (a 1e-5
               nudge of the input moves eps by 1.5%), while a block, two
               quantizers deep, stays below it;
  image_gap    every image of one sampled call of the timed path against
               the reference's own pipeline (its teacher, stage-1
               calibration, fold and int8 DDIM sampler) on the same noise:
               per image mean |difference| over mean |reference|, the
               largest over the images.

The fold is compared on the subject's own ranges because stage 1 is a
chain of quantizers whose argmin choices flip on rounding-level input
differences: two sound implementations land on ranges up to a fifth of a
span apart (the information line `ranges` prints the gap).  The reference's
served images come from its own calibration, so a calibration fault that
moves the grid shows there.
"""
from __future__ import annotations

import math
import time

import torch


class Subject:
    """What is judged: the teacher trajectory, the group ranges, the fold
    (`fold(name, step, kernel_shape) -> (codes, inv_ws, zcbias)`), the
    sampled call's images and its blocks' gaps [(step, name, gap)] (None:
    not read)."""

    def __init__(self, teacher, ranges, fold, images, blocks):
        self.teacher, self.ranges, self.fold, self.images, self.blocks = teacher, ranges, fold, images, blocks


def _gap(a, b):
    den = b.abs().max()
    return float((a.to(b.dtype) - b).abs().max() / den) if den > 0 else float((a - b).abs().max())


def fold_gap(ref, cfg, params, subject) -> float:
    worst = 0.0
    for name, cin, k, _stride, _h in ref.conv_sites(cfg):
        if not ref.folded(cin, k):
            continue
        p = ref.node(params, name)
        wb, ab, _g = ref.bits(cfg, name)
        f = ref.fold_conv(p["kernel"], p["bias"], subject.ranges[name], cin, wb, ab)
        for s in range(f["codes"].shape[0]):
            codes, inv_ws, zcbias = subject.fold(name, s, tuple(p["kernel"].shape))
            share = float((codes.to(torch.int8) != f["codes"][s]).float().mean())
            worst = max(worst, share, _gap(inv_ws, f["inv_ws"][s]), _gap(zcbias, f["zcbias"][s]))
    return worst


class BlockCheck:
    """`seen(step, name, h_in, h_out)` for `program.Blocks`: each block's
    gap (mean |h_out - reference| over mean |reference|), the reference's
    block run in float32 on h_in with the subject's `ranges` and its own
    fold of them; `gaps` [(step, name, gap)]."""

    def __init__(self, ref, cfg, params, ranges, sched):
        self.ref, self.cfg, self.params, self.ranges, self.sched = ref, cfg, params, ranges, sched
        self.folds = ref.fold(params, cfg, ranges)
        self.gaps = []

    def __call__(self, step, name, h_in, h_out):
        with self.ref.precision("f32"):
            want = self.ref.block_forward(self.params, self.cfg, self.folds, self.ranges, step, self.sched[step][0],
                                          name, h_in.to(torch.float32))
        g = float((h_out.to(torch.float32) - want).abs().mean() / want.abs().mean())
        self.gaps.append((step, name, g if math.isfinite(g) else math.inf))


def block_gaps(blocks) -> tuple:
    """(largest, median) of the blocks' gaps; inf where none was read."""
    if not blocks:
        return math.inf, math.inf
    gaps = sorted(g for _s, _n, g in blocks)
    return gaps[-1], gaps[len(gaps) // 2]


def ranges_gap(ref_ranges, ranges) -> tuple:
    """(median, max) over convs and steps of the group ranges' max |difference|
    over the conv's span at that step: information, not compared."""
    gaps = []
    for name, gr in ref_ranges.items():
        span = (gr[:, :, 1].amax(dim=1) - gr[:, :, 0].amin(dim=1))[:, None, None]
        gaps += ((ranges[name].to(gr.device) - gr).abs() / span).amax(dim=(1, 2)).tolist()
    gaps.sort()
    return gaps[len(gaps) // 2], gaps[-1]


def image_gaps(images, ref_images):
    a, b = images.to(ref_images.device, torch.float32).flatten(1), ref_images.flatten(1)
    gaps = (a - b).abs().mean(dim=1) / b.abs().mean(dim=1)
    return [g if math.isfinite(g) else math.inf for g in gaps.tolist()]


def reference_pipeline(ref, cfg, params, x_cal, x_call, sched, mode="f32", xs=None, log=None):
    """The reference's teacher (unless given as `xs`), ranges, fold and
    served images at precision `mode` (the configuration's a_bit from `cfg`)."""
    clock = Clock(x_call.device)
    with ref.precision(mode):
        xs = ref.teacher_inputs(params, cfg, x_cal, sched) if xs is None else xs
        ranges = clock("calibration", lambda: ref.calibrate(params, cfg, xs, sched))
        folds = clock("fold", lambda: ref.fold(params, cfg, ranges))
        images = clock("serving", lambda: ref.serve(params, cfg, folds, ranges, sched, x_call))
    if log:
        log(f"[check] reference ({mode}): " + ", ".join(f"{k} {v:.1f} s" for k, v in clock.seconds.items()))
    return xs, ranges, folds, images


class Clock:
    """Host seconds of named stages, each ended by a device sync."""

    def __init__(self, device):
        self.device, self.seconds = device, {}

    def __call__(self, name, fn):
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        self.seconds[name] = time.perf_counter() - t0
        return out


def judge(ref, cfg, traffic, limits, params, x_cal, x_call, subject, log, reference=None, release=None) -> dict:
    """{"numbers": {name: (value, limit)}, "correct": bool, "failed": images
    over the image limit}.  `reference` (the output of `reference_pipeline`)
    is computed here where not given.  `release()`, where given, is called
    once `subject.fold` has been read, before the reference's own pipeline
    runs, so that the caller can free the subject's fold first."""
    sched = ref.schedule(cfg, traffic["timesteps"], traffic["skip_type"], x_cal.device)
    clock = Clock(x_cal.device)
    with ref.precision("f32"):
        xs_ref = clock("teacher", lambda: ref.teacher_inputs(params, cfg, x_cal, sched))
        teacher = _gap(subject.teacher, xs_ref)
        fold = clock("fold check", lambda: fold_gap(ref, cfg, params, subject))
    log("[check] " + ", ".join(f"{k} {v:.1f} s" for k, v in clock.seconds.items()))
    if release is not None:
        release()
    block_max, block_median = block_gaps(subject.blocks)
    if subject.blocks:
        worst = max(subject.blocks, key=lambda b: b[2])
        log(f"[check] information: {len(subject.blocks)} blocks read, the largest gap at step {worst[0]} {worst[1]}")
    _xs, ranges, folds, ref_images = reference or reference_pipeline(ref, cfg, params, x_cal, x_call, sched,
                                                                     xs=xs_ref, log=log)
    del folds
    gaps = image_gaps(subject.images, ref_images)
    med, mx = ranges_gap(ranges, subject.ranges)
    log(f"[check] information: ranges against the reference's own stage 1, median {med:.4g} max {mx:.4g} of a span")
    numbers = {"teacher_gap": (teacher, limits["teacher_gap"]), "fold_gap": (fold, limits["fold_gap"]),
               "block_gap": (block_max, limits["block_gap"]),
               "block_median": (block_median, limits["block_median"]), "image_gap": (max(gaps), limits["image_gap"])}
    correct = all(math.isfinite(v) and v <= lim for v, lim in numbers.values())
    return {"numbers": numbers, "correct": correct, "failed": sum(1 for g in gaps if not g <= limits["image_gap"]),
            "images": len(gaps)}
