"""Batch iterator (port of `attentiondm_tpu/data/loader.py`): shuffled
epochs of stacked NHWC float32 batches on the host, with an optional
threaded prefetch.

Numpy as in JAX, so the batches are the same: the epoch's order is
`default_rng(seed)`'s shuffle, the last partial batch is dropped
(`drop_last`), and `workers=N` builds up to `prefetch` batches ahead on a
thread pool, consumed in submission order, byte-identical to `workers=0`.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _batch_slices(n: int, batch_size: int, shuffle: bool, seed: int, drop_last: bool):
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    return [order[s: s + batch_size] for s in range(0, end, batch_size)]


def iterate_batches(dataset, batch_size: int, *, shuffle=True, seed=0, drop_last=True, workers: int = 0,
                    prefetch: int | None = None):
    """Yield (x [B, H, W, C] float32, y [B]) numpy batches for one epoch.

    workers=0 fetches in the caller's thread; workers > 0 builds batches on
    a ThreadPoolExecutor with up to `prefetch` (default max(2, workers)) in
    flight; a worker's exception surfaces on the yield of its batch."""
    slices = _batch_slices(len(dataset), batch_size, shuffle, seed, drop_last)

    def build(idx):
        xs, ys = zip(*(dataset[int(i)] for i in idx))
        return np.stack(xs).astype(np.float32), np.asarray(ys)

    if workers <= 0:
        for idx in slices:
            yield build(idx)
        return

    depth = max(2, workers) if prefetch is None else max(1, prefetch)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending: collections.deque = collections.deque()
        try:
            for idx in slices:
                pending.append(ex.submit(build, idx))
                if len(pending) >= depth:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            # a generator closed early drops its queued work, so that the executor's join does not run the epoch
            for f in pending:
                f.cancel()
