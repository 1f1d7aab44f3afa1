"""Exponential moving average of a param tree (port of `attentiondm_tpu/models/ema.py`).

shadow <- (1 - mu) p + mu shadow, leaf by leaf, without autograd.
"""
from __future__ import annotations

import torch

from .unet import map_tree, tree_leaves, tree_unflatten


def ema_init(params):
    """The shadow's start: a copy of the params."""
    return map_tree(lambda p: p.detach().clone(), params)


@torch.no_grad()
def ema_update(shadow, params, mu: float = 0.999):
    """(1 - mu) * p + mu * s for every leaf, in that order of operations."""
    s, p = tree_leaves(shadow), tree_leaves(params)
    out = torch._foreach_mul(p, 1.0 - mu)
    torch._foreach_add_(out, torch._foreach_mul(s, mu))
    return tree_unflatten(shadow, out)


def ema_params(shadow):
    """The EMA weights to sample with (the shadow itself)."""
    return shadow
