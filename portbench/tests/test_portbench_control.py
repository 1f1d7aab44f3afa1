"""The controls come out not correct, on the CPU at the toy size and on the
card: the port with its own bfloat16 residual stream (one step below the
float32 stream the configuration states) through the block numbers, and
the reference one precision step below the configuration's (TF32 products
and 4-bit activations) put in the program's place through the others."""
import json

import pytest
import torch

from portbench import control
from portbench.harness import check, runner
from portbench.harness.registry import Registry


def readings(root, cell, seed, dev, subjects):
    reg = Registry(root)
    w = reg.cell(cell)
    cfg, mix, limits = reg.config(w["config"]), reg.traffic(w["traffic"]), reg.limits(cell)
    ref = reg.reference(cfg)
    params, x_cal, make_input = runner.inputs(cfg, mix, ref, seed, dev)
    x = make_input(runner.STREAM_CALLS)
    sched = ref.schedule(cfg, mix["timesteps"], mix["skip_type"], dev)
    reference = check.reference_pipeline(ref, cfg, params, x_cal, x, sched)
    out = {}
    for name in subjects:
        if name in control.PROGRAM:
            subject, _ = control.program_subject(ref, cfg, mix, params, x_cal, x, sched, dev, **control.PROGRAM[name])
        else:
            mode, a_bit = control.SUBJECTS[name]
            subject = control.reference_subject(ref, cfg, params, x_cal, x, sched, mode, a_bit or cfg["quant"]["a_bit"])
        out[name] = check.judge(ref, cfg, mix, limits, params, x_cal, x, subject, lambda m: None, reference=reference)
    return out


@pytest.mark.parametrize("seed", [11, 12])
def test_control_is_not_correct_on_the_cpu(toy, seed):
    root, cell = toy
    r = readings(root, cell, seed, torch.device("cpu"), ["program", "bf16_stream", "combined"])
    assert r["program"]["correct"] is True
    assert r["combined"]["correct"] is False
    assert r["combined"]["numbers"]["image_gap"][0] > 3 * r["program"]["numbers"]["image_gap"][0]
    assert r["bf16_stream"]["correct"] is False
    assert r["bf16_stream"]["numbers"]["block_median"][0] > 3 * r["program"]["numbers"]["block_median"][0]


@pytest.mark.gpu
def test_control_is_not_correct_on_the_card(toy, card):
    root, cell = toy
    r = readings(root, cell, 21, card, ["program", "bf16_stream", "combined"])
    assert r["program"]["correct"] is True and r["combined"]["correct"] is False
    v = {k: r["combined"]["numbers"][k][0] for k in ("teacher_gap", "fold_gap", "image_gap")}
    assert all(v[k] > r["combined"]["numbers"][k][1] for k in v), json.dumps(v)
    b = {k: r["bf16_stream"]["numbers"][k] for k in ("block_gap", "block_median")}
    assert r["bf16_stream"]["correct"] is False and b["block_median"][0] > b["block_median"][1], json.dumps(b)
