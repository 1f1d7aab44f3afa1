"""Rank-1 (step-factorized) activation scales -> step-shared int8 folds
(port of `attentiondm_tpu/quant/rank1.py`).

The per-step serving fold exists because per-channel activation scales fold
into the weight operand of the integer GEMM: with free per-(step, channel)
scales s[t, c], the folded matrix g[t] = W / s[t] requantizes per step, so
the runtime holds S x params of int8 weights (ImageNet-64 at 100 steps:
about 29 GB).

This module constrains the activation scales to a rank-1 factorization

    s'[t, c] = m[t] * u[c]

(log-space least squares onto the calibrated s[t, c]).  Then g[t] = (W / u)
/ m[t], and the symmetric per-output-channel weight grid is
scale-invariant: ws[t] = m[t] * ws_u gives the same integer weights for
every step.  The fold holds gq once ([1, K, Np]; `gather_step` treats a
singleton step axis as shared); per-step variation lives in the dequant
vectors (inv_ws, zcbias [S, Np]) and the activation quantizer (scale, zp
[S, C]).

The constraint costs per-(t, c) freedom in the quantization window's width
only: the zero point re-centres the window on the calibrated range's
midpoint (`rank1_scale_zp`).
"""
from __future__ import annotations

import torch

from .primitives import div
from .state import ActQuantState, mixed_ranges


def _ranges_all(st: ActQuantState):
    """Per-step per-channel (rmin, rmax) [S, C] from the softmax mixture."""
    rmin, rmax = zip(*(mixed_ranges(st, s) for s in range(st.alpha_logits.shape[0])))
    return torch.stack(rmin), torch.stack(rmax)


def rank1_factors(st: ActQuantState, a_bit: int):
    """Log-space least-squares rank-1 factorization of the effective scales:
    (u [C], m [S]) with s'[t, c] = m[t] * u[c], normalized so that mean(log
    m) == 0 (u carries the magnitude)."""
    rmin, rmax = _ranges_all(st)
    n_lv = 2 ** a_bit - 1
    s_tc = div(n_lv, torch.clamp(rmax - rmin, min=1e-12))  # [S, C]
    ls = torch.log(torch.clamp(s_tc, min=1e-12))
    lu = ls.mean(dim=0)  # [C]
    lm = (ls - lu[None, :]).mean(dim=1)  # [S]
    return torch.exp(lu), torch.exp(lm)


def rank1_scale_zp(st: ActQuantState, a_bit: int, u, m):
    """Per-step activation quantization on the rank-1 scales: the window
    width is n_lv / s'[t, c], its zero point re-centres it on the calibrated
    range's midpoint.  Returns (scale [S, C], zp [S, C]), the contract of
    the per-step fold's ranges (q = round(scale * x - zp))."""
    rmin, rmax = _ranges_all(st)
    n_lv = 2 ** a_bit - 1
    scale = m[:, None] * u[None, :]  # [S, C]
    width = div(n_lv, scale)
    center = 0.5 * (rmin + rmax)
    rmin_c = center - 0.5 * width
    zp = torch.round(scale * rmin_c) + 2 ** (a_bit - 1)
    return scale, zp
