"""Per-step metrics as CSV rows (port of `MetricsLogger` in
`attentiondm_tpu/utils/metrics_log.py`): (step, wall_s, **metrics) rows
appended to a CSV file whose header is the first row's keys, as JAX's
writes them."""
from __future__ import annotations

import csv
import os
import time


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
