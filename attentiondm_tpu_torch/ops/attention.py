"""Dense spatial attention for the FP UNet (port of the dense branch of
`attentiondm_tpu/ops/attention.spatial_attention`).

The FP teacher runs attention at L = 256 on CIFAR, where the JAX package
takes a plain fused softmax.  Long maps (L >= 1024) went to the Pallas flash
kernel K11 (`attentiondm_tpu/ops/attention.py:53`), which is not ported yet.
"""
from __future__ import annotations

import torch


def spatial_attention(q, k, v, *, scale=None):
    """softmax(q k^T * scale) v in float32; q, k, v: [B, L, D]."""
    B, L, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if L >= 1024 and L % 256 == 0 and D % 128 == 0:
        raise NotImplementedError(
            "L >= 1024 takes the flash-attention kernel K11, still to be ported "
            "(ROADMAP Queue 2)"
        )
    w = torch.einsum("blc,bmc->blm", q.float(), k.float()) * scale
    w = torch.softmax(w, dim=-1)
    return torch.einsum("blm,bmc->blc", w, v.float()).to(q.dtype)
