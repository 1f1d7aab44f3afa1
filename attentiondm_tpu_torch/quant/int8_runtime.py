"""Per-step weight fold (port of the symmetric branches of
`attentiondm_tpu/quant/int8_runtime._fold_all_steps`, per-step and rank-1).

After calibration the per-timestep activation quantization is frozen, so
everything weight-side is precomputed: for each eligible conv and each
sampler step, fold the step's per-channel activation scales into the kernel
and quantize at w_bit.  The MSE range shrink is searched once per layer on
the mean-over-steps scale and shared by every step.  With `rank1` the
activation scales are first constrained to m[t] * u[c] (quant/rank1.py) and
the weights fold once, on u: one int8 copy for every step.
"""
from __future__ import annotations

import torch

from ..ops.quant_conv import fold_shrink_search, fold_weights_int8, zcorr_from_fold
from .primitives import div
from .rank1 import rank1_factors, rank1_scale_zp
from .state import ActQuantState


def _eligible(kernel_shape, stride=1):
    kh, kw, ci, _ = kernel_shape
    return stride == 1 and ci >= 64 and (kh, kw) in ((1, 1), (3, 3))


def _step_ranges(group_ranges, alpha_logits, a_bit: int):
    """Per-step (scale, zp) [S, C] from the softmax group mixture."""
    sw = torch.softmax(alpha_logits, dim=1)  # [S, G, C]
    rmin = (group_ranges[:, :, 0:1] * sw).sum(dim=1)
    rmax = (group_ranges[:, :, 1:2] * sw).sum(dim=1)
    scale = div(2 ** a_bit - 1, rmax - rmin)
    zp = torch.round(scale * rmin) + 2 ** (a_bit - 1)
    return scale, zp


def _fold_all_steps(kernel, group_ranges, alpha_logits, a_bit: int, w_bit: int, rank1: bool = False,
                    steps: slice | None = None):
    """Fold + quantize one conv's weights for every sampler step: the
    symmetric, MSE-searched branches without weight extras
    (`prepare_serving_runtime` rejects the others).

    Returns (gq [S, K, Np] int8, ws [S, Np], wzp [S, Np], zcorr [S, Np],
    act_scale [S, C], act_zp [S, C]).  With `rank1` gq is [1, K, Np], shared
    by every step (ws = ws_u * m[s], zcorr from g_hat_u / m[s]).

    `steps` (a slice of the schedule, for `step_chunk`) folds those steps
    only, with the shrink searched on the whole schedule's mean scale, so a
    chunk's fold is the same rows of the whole fold.  (JAX searches it on
    the chunk's steps, so its chunked sampler can differ from its unchunked
    one; ROADMAP Queue 3.)"""
    kh, C = kernel.shape[0], kernel.shape[2]
    if rank1:
        S = alpha_logits.shape[0]
        zeros = dict(dtype=torch.float32, device=kernel.device)
        st = ActQuantState(init_range=torch.zeros((S, 2), **zeros), act_min=torch.zeros((S, C), **zeros),
                           act_max=torch.zeros((S, C), **zeros), group_ranges=group_ranges,
                           alpha_logits=alpha_logits)
        u, m = rank1_factors(st, a_bit)
        scale, zp = rank1_scale_zp(st, a_bit, u, m)  # [S, C]
        shrink = fold_shrink_search(kernel, u, w_bit, symmetric=True)
        gq_u, ws_u, _wzp, g_hat_u = fold_weights_int8(kernel, u, w_bit, symmetric=True, shrink=shrink)
        ws = torch.stack([ws_u * m[s] for s in range(S)])
        zc = torch.stack([zcorr_from_fold(g_hat_u / m[s], zp[s], kh, C) for s in range(S)])
        return gq_u[None], ws, torch.zeros_like(ws), zc, scale, zp
    scale, zp = _step_ranges(group_ranges, alpha_logits, a_bit)
    shrink = fold_shrink_search(kernel, scale.mean(dim=0), w_bit, symmetric=True)
    if steps is not None:
        scale, zp = scale[steps], zp[steps]
    outs = []
    for s in range(scale.shape[0]):
        gq, ws, wzp, g_hat = fold_weights_int8(kernel, scale[s], w_bit, symmetric=True, shrink=shrink)
        outs.append((gq, ws, wzp, zcorr_from_fold(g_hat, zp[s], kh, C)))
    gq, ws, wzp, zc = (torch.stack(t) for t in zip(*outs))
    return gq, ws, wzp, zc, scale, zp
