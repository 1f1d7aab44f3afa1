"""A whole run of the toy cell on the CPU (the harness's look for a card
skipped): the result line's shape, no device metric, and `correct`."""
import json
import time

import pytest

from portbench.harness.registry import Registry
from portbench.harness.runner import execute

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_cpu_dry_run_prints_no_device_metric(toy, trace):
    root, cell = toy
    r = execute(Registry(root), cell, 2 ** 31 + 11, 0.2, trace, "cpu", time.perf_counter())
    assert list(r) == KEYS  # `checks` last; no breakdown without a card
    json.dumps(r)
    assert r["metrics"] == {}
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 4 == 0 and r["attempted"] >= 4
    assert set(r["checks"]) == {"teacher_gap", "fold_gap", "block_gap", "block_median", "image_gap"}
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
