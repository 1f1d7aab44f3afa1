"""The run drives the timed path with a fault planted underneath it and
`correct` comes out false, once for each fault this cell can have (it runs
on one chip: there is no exchange between chips to leave out)."""
import time

import pytest
import torch

from portbench.harness.registry import Registry
from portbench.harness.runner import execute


def step_unchanged(sample):
    """A sampler step that returns its state unchanged: the first serving
    step's forward is skipped and x goes on as it came in."""
    from attentiondm_tpu_torch.quant import int8_serving

    real = int8_serving.step_rule

    def rule_factory(*a, **kw):
        rule = real(*a, **kw)

        def rule_(i, x, *rest):
            return (x, x) if i == 0 else rule(i, x, *rest)

        return rule_

    def call(x):
        int8_serving.step_rule = rule_factory
        try:
            return sample(x)
        finally:
            int8_serving.step_rule = real

    return call


def half_batch(sample):
    """Half of the batch left out: only the first half is sampled, the rest
    handed back as it came in."""

    def call(x):
        n = x.shape[0] // 2
        return torch.cat([sample(x[:n]), x[n:]])

    return call


def answer_altered(sample):
    """An answer altered where it is produced: the last image of every call
    comes back mirrored."""

    def call(x):
        out = sample(x)
        out[-1] = out[-1].flip(0)
        return out

    return call


@pytest.mark.parametrize("fault", [step_unchanged, half_batch, answer_altered])
def test_a_planted_fault_is_not_correct(toy, fault):
    root, cell = toy
    r = execute(Registry(root), cell, 97, 0.2, False, "cpu", time.perf_counter(), wrap_sampler=fault)
    assert r["correct"] is False
    assert r["checks"]["image_gap"]["value"] > r["checks"]["image_gap"]["limit"]
    assert r["failed"] >= 1
