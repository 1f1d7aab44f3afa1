"""Per-step weight fold (port of the symmetric, non-rank-1 branch of
`attentiondm_tpu/quant/int8_runtime._fold_all_steps`).

After calibration the per-timestep activation quantization is frozen, so
everything weight-side is precomputed: for each eligible conv and each
sampler step, fold the step's per-channel activation scales into the kernel
and quantize at w_bit.  The MSE range shrink is searched once per layer on
the mean-over-steps scale and shared by every step.
"""
from __future__ import annotations

import torch

from ..ops.quant_conv import fold_shrink_search, fold_weights_int8, zcorr_from_fold
from .primitives import div


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


def _fold_all_steps(kernel, group_ranges, alpha_logits, a_bit: int, w_bit: int):
    """Fold + quantize one conv's weights for every sampler step: the
    symmetric, MSE-searched, non-rank-1 branch (`prepare_serving_runtime`
    rejects the others).

    Returns (gq [S, K, Np] int8, ws [S, Np], wzp [S, Np], zcorr [S, Np],
    act_scale [S, C], act_zp [S, C])."""
    kh, C = kernel.shape[0], kernel.shape[2]
    scale, zp = _step_ranges(group_ranges, alpha_logits, a_bit)
    shrink = fold_shrink_search(kernel, scale.mean(dim=0), w_bit, symmetric=True)
    outs = []
    for s in range(scale.shape[0]):
        gq, ws, wzp, g_hat = fold_weights_int8(kernel, scale[s], w_bit, symmetric=True, shrink=shrink)
        outs.append((gq, ws, wzp, zcorr_from_fold(g_hat, zp[s], kh, C)))
    gq, ws, wzp, zc = (torch.stack(t) for t in zip(*outs))
    return gq, ws, wzp, zc, scale, zp
