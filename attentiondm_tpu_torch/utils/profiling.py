"""Tracing and timing helpers (port of `attentiondm_tpu/utils/profiling.py`).

`trace_annotation` names a region in torch.profiler's trace
(`torch.profiler.record_function`); `StepTimer` times steps to their end on
the device (each lap ends on a device sync, since a CUDA launch returns
before its work is done); `SmoothedValue` keeps a windowed and a global
average of a metric and sums its (count, total) across the processes of a
`torch.distributed` group when one is up.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from ..models.unet import tree_leaves


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named region in profiler traces (next to no cost when not tracing)."""
    with torch.profiler.record_function(name):
        yield


def _sync(result_ref):
    """Wait for the device: that of `result_ref[0]`'s first leaf (a tensor,
    or a dict / list / tuple tree of them) where it is a CUDA tensor, else
    the current CUDA device once CUDA is in use."""
    leaves = tree_leaves(result_ref[0]) if result_ref else []
    if leaves and isinstance(leaves[0], torch.Tensor) and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Host-clock laps that end on a device sync."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def lap(self, result_ref: list | None = None):
        """Time the block; `result_ref` ([the step's output], filled in by
        the block) names the device to wait for."""
        t0 = time.perf_counter()
        yield
        _sync(result_ref)
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self):
        return min(self.times) if self.times else float("nan")

    @property
    def mean(self):
        return float(np.mean(self.times)) if self.times else float("nan")


class SmoothedValue:
    """Windowed and global average of a scalar metric."""

    def __init__(self, window_size: int = 20):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.total += float(value) * n
        self.count += n

    def synchronize_between_processes(self):
        """Sum (count, total) over the processes of the default
        `torch.distributed` group (an all_reduce); nothing in a single
        process."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
        vals = torch.tensor([float(self.count), self.total], dtype=torch.float64, device=dev)
        dist.all_reduce(vals)
        self.count = int(vals[0].item())
        self.total = float(vals[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else float("nan")

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else float("nan")

    @property
    def global_avg(self):
        return self.total / max(1, self.count)
