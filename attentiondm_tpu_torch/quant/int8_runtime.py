"""Per-step weight fold (port of the symmetric branches of
`attentiondm_tpu/quant/int8_runtime._fold_all_steps`, per-step and rank-1,
with the weight extras).

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
import torch.nn.functional as F

from ..ops.quant_conv import fold_shrink_search, fold_weights_int8, grid_absmax, zcorr_from_fold
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


def _refine(ws, g_hat, co, out_mult, s, absmax=None, w_bit=None):
    """A refinement's `out_mult` ([co], or [S, co] read at row s) on one step's
    fold: it divides ws and multiplies g_hat per output channel (the int8
    grid is untouched); the padded columns keep 1.  Given the grid's
    `absmax`, ws is (2^(w_bit-1) - 1) / (absmax * out_mult): XLA rewrites
    JAX's (n / absmax) / out_mult so, and this gives its bits."""
    if out_mult is None:
        return ws, g_hat
    om = (out_mult if out_mult.ndim == 1 else out_mult[s]).to(ws.dtype)
    Np = ws.shape[0]
    if absmax is None:
        ws = ws / F.pad(om, (0, Np - co), value=1.0)
    else:
        ws = F.pad(div(2 ** (w_bit - 1) - 1, absmax * om), (0, Np - co), value=1.0)
    return ws, g_hat * F.pad(om, (0, Np - co), value=1.0)[None, :]


def _zcorr(kernel, scale, g_hat, zp, input_mu, bias_delta, s):
    """One step's epilogue constant: the zero-point correction, plus with
    `input_mu` the bias correction mu @ (g - g_hat) and with `bias_delta`
    ([co], or [S, co] read at row s) the refinement's shift, both on the co
    unpadded columns."""
    kh, C, co = kernel.shape[0], kernel.shape[2], kernel.shape[3]
    zc = zcorr_from_fold(g_hat, zp, kh, C)
    if input_mu is None and bias_delta is None:
        return zc
    zc = zc.clone()
    if input_mu is not None:
        g = (kernel / scale.reshape(1, 1, C, 1)).reshape(kh * kh * C, co)
        Cp = g_hat.shape[0] // (kh * kh)
        gh = g_hat.reshape(kh * kh, Cp, -1)[:, :C, :co].reshape(kh * kh * C, co)
        zc[:co] += input_mu @ (g - gh)
    if bias_delta is not None:
        zc[:co] += (bias_delta if bias_delta.ndim == 1 else bias_delta[s]).to(zc.dtype)
    return zc


def _fold_all_steps(kernel, group_ranges, alpha_logits, a_bit: int, w_bit: int, rank1: bool = False,
                    steps: slice | None = None, round_offset=None, input_mu=None, shrink=None, out_mult=None,
                    bias_delta=None):
    """Fold + quantize one conv's weights for every sampler step: the
    symmetric, MSE-searched branches (`prepare_serving_runtime` rejects
    asymmetric folds).

    Returns (gq [S, K, Np] int8, ws [S, Np], wzp [S, Np], zcorr [S, Np],
    act_scale [S, C], act_zp [S, C]).  With `rank1` gq is [1, K, Np], shared
    by every step (ws = ws_u * m[s], zcorr from g_hat_u / m[s]).

    The weight extras (`quant.adaround.WeightExtras`) change the fold only:
    `round_offset` [kh, kw, C, co] replaces round-to-nearest
    (`fold_weights_int8`), shared by every step; `input_mu` [kh*kw*C] adds the
    bias correction mu @ (g - g_hat) to each step's zcorr; a `shrink` [co]
    is pinned in place of the search; `out_mult` and `bias_delta` ([co], or
    [S, co] a row per step) rescale ws / g_hat and shift zcorr.

    `steps` (a slice of the schedule, for `step_chunk`) folds those steps
    only (the [S, co] extras' rows too), with the shrink searched on the
    whole schedule's mean scale, so a chunk's fold is the same rows of the
    whole fold.  (JAX searches it on the chunk's steps, so its chunked
    sampler can differ from its unchunked one: ROADMAP Queue 3, the
    reference's own faults.)"""
    kh, C, co = kernel.shape[0], kernel.shape[2], kernel.shape[3]
    if rank1:
        S = alpha_logits.shape[0]
        zeros = dict(dtype=torch.float32, device=kernel.device)
        st = ActQuantState(init_range=torch.zeros((S, 2), **zeros), act_min=torch.zeros((S, C), **zeros),
                           act_max=torch.zeros((S, C), **zeros), group_ranges=group_ranges,
                           alpha_logits=alpha_logits)
        u, m = rank1_factors(st, a_bit)
        scale, zp = rank1_scale_zp(st, a_bit, u, m)  # [S, C]
        if shrink is None:
            shrink = fold_shrink_search(kernel, u, w_bit, symmetric=True)
        gq_u, ws_u, _wzp, g_hat_u = fold_weights_int8(kernel, u, w_bit, symmetric=True, shrink=shrink,
                                                      round_offset=round_offset)
        ws, zc = [], []
        for s in range(S):
            ws_s, g_hat_s = _refine(ws_u * m[s], g_hat_u / m[s], co, out_mult, s)
            ws.append(ws_s)
            zc.append(_zcorr(kernel, scale[s], g_hat_s, zp[s], input_mu, bias_delta, s))
        ws = torch.stack(ws)
        return gq_u[None], ws, torch.zeros_like(ws), torch.stack(zc), scale, zp
    scale, zp = _step_ranges(group_ranges, alpha_logits, a_bit)
    if shrink is None:
        shrink = fold_shrink_search(kernel, scale.mean(dim=0), w_bit, symmetric=True)
    if steps is not None:
        scale, zp = scale[steps], zp[steps]
        out_mult, bias_delta = (v if v is None or v.ndim == 1 else v[steps] for v in (out_mult, bias_delta))
    outs = []
    for s in range(scale.shape[0]):
        gq, ws, wzp, g_hat = fold_weights_int8(kernel, scale[s], w_bit, symmetric=True, shrink=shrink,
                                               round_offset=round_offset)
        if out_mult is not None:
            absmax = grid_absmax(kernel / scale[s].reshape(1, 1, C, 1), shrink)
            ws, g_hat = _refine(ws, g_hat, co, out_mult, s, absmax, w_bit)
        outs.append((gq, ws, wzp, _zcorr(kernel, scale[s], g_hat, zp[s], input_mu, bias_delta, s)))
    gq, ws, wzp, zc = (torch.stack(t) for t in zip(*outs))
    return gq, ws, wzp, zc, scale, zp
