"""Group-wise range construction (port of `attentiondm_tpu/quant/groupwise.py`).

Bucket a per-channel range vector x[C] into `group_n` uniform-width buckets
over [x.min(), x.max()], take each bucket's max (upper ranges) or min (lower
ranges) as its threshold, and snap every channel to its bucket's threshold.
Buckets are inclusive on both sides, so at a shared edge the LATER bucket
wins; an empty bucket falls back to its upper edge.

Returns (snapped [C], group_values [G]).
"""
from __future__ import annotations

import torch


def groupwise_ranges(x, group_n: int = 8, maxmin: str = "max"):
    range_min = x.min()
    range_max = x.max()
    div = range_max - range_min
    steps = torch.arange(1, group_n + 1, device=x.device)
    uppers = range_min + div * (steps / group_n).to(x.dtype)
    lowers = torch.cat([range_min[None], uppers[:-1]])

    in_bucket = (x[None, :] >= lowers[:, None]) & (x[None, :] <= uppers[:, None])  # [G, C]
    idx = steps[:, None]
    mark = torch.where(in_bucket, idx, torch.zeros_like(idx)).max(dim=0).values  # [C], 1-based
    members = idx == mark[None, :]

    big = torch.finfo(x.dtype).max
    xb = x[None, :].expand(group_n, -1)
    if maxmin == "max":
        vals = torch.where(members, xb, torch.full_like(xb, -big)).max(dim=1).values
    else:
        vals = torch.where(members, xb, torch.full_like(xb, big)).min(dim=1).values
    group_vals = torch.where(members.any(dim=1), vals, uppers)
    return group_vals[mark - 1], group_vals
