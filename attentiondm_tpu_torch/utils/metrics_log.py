"""Per-step metrics (port of `attentiondm_tpu/utils/metrics_log.py`):
`MetricsLogger`, (step, wall_s, **metrics) rows appended to a CSV file whose
header is the first row's keys, as JAX's writes them; `AverageMeter`; and
`log_every`, an iterator that logs its progress."""
from __future__ import annotations

import csv
import logging
import os
import time

import torch


class AverageMeter:
    """The last value, sum, count and average of a metric."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(1, self.count)


class MetricsLogger:
    """Append-only CSV of (step, wall_time, **metrics)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fields = None
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3), **metrics}
        write_header = self._fields is None
        if write_header:
            self._fields = list(row.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if write_header and f.tell() == 0:
                w.writeheader()
            w.writerow(row)


def log_every(iterable, print_freq: int, header: str = "", logger=None):
    """Yield the items of `iterable`, logging every `print_freq`-th (and the
    last) with the mean ms an item, the ETA and, once CUDA is in use, the
    current device's allocated memory; then the total seconds."""
    log = logger or logging.getLogger(__name__)
    items = iterable if hasattr(iterable, "__len__") else list(iterable)
    total = len(items)
    t0 = time.time()
    iter_time = AverageMeter("iter")
    t_prev = t0
    for i, obj in enumerate(items):
        yield obj
        now = time.time()
        iter_time.update(now - t_prev)
        t_prev = now
        if i % print_freq == 0 or i == total - 1:
            eta = iter_time.avg * (total - i - 1)
            mem = ""
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                mem = f" mem {torch.cuda.memory_allocated() / 1e9:.2f}GB"
            log.info(f"{header} [{i}/{total}] {iter_time.avg * 1e3:.0f}ms/it eta {eta:.0f}s{mem}")
    log.info(f"{header} total {time.time() - t0:.1f}s")
