"""The per-step weight fold and the interception runtime (port of
`attentiondm_tpu/quant/int8_runtime.py`).

After calibration the per-timestep activation quantization is frozen, so
everything weight-side is precomputed: for each eligible conv and each
sampler step, fold the step's per-channel activation scales into the kernel
and quantize at w_bit, symmetric (the serving path's folds) or asymmetric
(the interception runtime's, with a zero point and the rowsum term).  The
MSE range shrink is searched once per layer on the mean-over-steps scale and
shared by every step.  With `rank1` the activation scales are first
constrained to m[t] * u[c] (quant/rank1.py) and the weights fold once, on u:
one int8 copy for every step.

The interception runtime (`prepare_int8_runtime`, `make_int8_conv_apply`,
`int8_model_fn`) runs the FP UNet's graph with each eligible conv replaced
by `ops/quant_conv.quantized_conv2d_int8_prefolded` at the step's fold:
float activations between convs, each conv quantizing its input, K1's int32
modes for the product (K13 for 3x3, K5 for 1x1) and the dequant in plain
torch.  The fused serving path (quant/int8_serving.py) serves the same
folds int8-resident.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device
from ..models.unet import conv2d, iter_conv_layers, lookup, unet_apply
from ..ops.pallas_conv import k_major
from ..ops.quant_conv import (
    fold_shrink_search,
    fold_weights_int8,
    grid_span,
    quantized_conv2d_int8_prefolded,
    zcorr_from_fold,
)
from .primitives import div
from .rank1 import rank1_factors, rank1_scale_zp
from .state import ActQuantState, quantize_activation


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


def _refine(ws, g_hat, co, out_mult, s, span=None, levels=None):
    """A refinement's `out_mult` ([co], or [S, co] read at row s) on one step's
    fold: it divides ws and multiplies g_hat per output channel (the int8
    grid is untouched); the padded columns keep 1.  Given the grid's `span`
    and `levels` (`grid_span`), ws is levels / (span * out_mult): XLA
    rewrites JAX's (levels / span) / out_mult so, and this gives its bits."""
    if out_mult is None:
        return ws, g_hat
    om = (out_mult if out_mult.ndim == 1 else out_mult[s]).to(ws.dtype)
    Np = ws.shape[0]
    if span is None:
        ws = ws / F.pad(om, (0, Np - co), value=1.0)
    else:
        ws = F.pad(div(levels, span * om), (0, Np - co), value=1.0)
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


def _fold_all_steps(kernel, group_ranges, alpha_logits, a_bit: int, w_bit: int, symmetric: bool = True,
                    mse_search: bool = True, rank1: bool = False, steps: slice | None = None, round_offset=None,
                    input_mu=None, shrink=None, out_mult=None, bias_delta=None):
    """Fold + quantize one conv's weights for every sampler step.

    Returns (gq [S, K, Np] int8, ws [S, Np], wzp [S, Np], zcorr [S, Np],
    act_scale [S, C], act_zp [S, C]).  `symmetric=False` quantizes each
    output channel on an asymmetric grid (`weight_grid`; wzp nonzero: the
    interception runtime's folds).  `mse_search=False` takes a unit shrink
    instead of the MSE search.  With `rank1` gq is [1, K, Np], shared by
    every step (ws = ws_u * m[s], zcorr from g_hat_u / m[s]); it takes
    symmetric weights only (a rounded zero point breaks the scale invariance
    the shared fold rests on), as in JAX.

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
    if shrink is None and not mse_search:
        shrink = torch.ones(co, dtype=kernel.dtype, device=kernel.device)
    if rank1:
        if not symmetric:
            raise ValueError("rank1 shared folds require symmetric weights (an asymmetric grid's rounded zero point "
                             "breaks the scale invariance the shared fold rests on)")
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
        shrink = fold_shrink_search(kernel, scale.mean(dim=0), w_bit, symmetric)
    if steps is not None:
        scale, zp = scale[steps], zp[steps]
        out_mult, bias_delta = (v if v is None or v.ndim == 1 else v[steps] for v in (out_mult, bias_delta))
    outs = []
    for s in range(scale.shape[0]):
        gq, ws, wzp, g_hat = fold_weights_int8(kernel, scale[s], w_bit, symmetric=symmetric, shrink=shrink,
                                               round_offset=round_offset)
        if out_mult is not None:
            levels, span = grid_span(kernel / scale[s].reshape(1, 1, C, 1), w_bit, symmetric, shrink)
            ws, g_hat = _refine(ws, g_hat, co, out_mult, s, span, levels)
        outs.append((gq, ws, wzp, _zcorr(kernel, scale[s], g_hat, zp[s], input_mu, bias_delta, s)))
    gq, ws, wzp, zc = (torch.stack(t) for t in zip(*outs))
    return gq, ws, wzp, zc, scale, zp


# ---------------------------------------------------------------------------
# the interception runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Int8Layer:
    """One conv's fold for every step, as the interception runtime reads it.

    gqt       [S, Np, K] int8   the quantized weights K-major (K1 reads them),
                                the one copy held
    gq        [S, K, Np] int8   JAX's layout, which the plain versions read:
                                the view `gqt.transpose(-1, -2)`
    ws, wzp, zcorr [S, Np]      weight scale, weight zero point (0 for a
                                symmetric fold), zero-point correction
    act_scale, act_zp [S, C]    the input's activation quantization

    Made from `gq` (transposed once into `gqt`) or from `gqt` (`gq=None`)."""

    gq: torch.Tensor
    ws: torch.Tensor
    wzp: torch.Tensor
    zcorr: torch.Tensor
    act_scale: torch.Tensor
    act_zp: torch.Tensor
    gqt: torch.Tensor = None

    def __post_init__(self):
        if self.gqt is None:
            self.gqt = k_major(self.gq)
        self.gq = self.gqt.transpose(-1, -2)


_INT8_FIELDS = ("gq", "ws", "wzp", "zcorr", "act_scale", "act_zp")


def from_jax_int8_runtime(tree, device=None) -> Dict[str, Int8Layer]:
    """{name: JAX `Int8Layer`} (its fields as numpy arrays or anything
    `np.asarray` reads) -> {name: Int8Layer} on `device` (None: the
    package's `default_device()`)."""
    device = default_device() if device is None else device
    return {name: Int8Layer(*(torch.tensor(np.asarray(getattr(lay, f)), device=device) for f in _INT8_FIELDS))
            for name, lay in tree.items()}


def prepare_int8_runtime(qunet, params, qstates: Dict[str, ActQuantState], symmetric: bool = True,
                         mse_search: bool = True, weight_extras=None) -> Dict[str, Int8Layer]:
    """Fold and quantize the weights of every eligible conv for every step
    (`_fold_all_steps`): {name: Int8Layer}.  `symmetric=False` folds on
    asymmetric grids (the int8 products then take the rowsum term);
    `weight_extras` {name: WeightExtras} (quant/adaround.py) go into each
    fold.  Pass the float params."""
    runtime = {}
    for name, _cin, _k in iter_conv_layers(qunet.cfg):
        kernel = lookup(params, name)["kernel"]
        if not _eligible(kernel.shape):
            continue
        st, pol = qstates[name], qunet.policy[name]
        ex = weight_extras.get(name) if weight_extras else None
        extras = {} if ex is None else dict(round_offset=ex.round_offset, input_mu=ex.mu, shrink=ex.shrink,
                                            out_mult=ex.out_mult, bias_delta=ex.bias_delta)
        gq, ws, wzp, zc, scale, zp = _fold_all_steps(kernel, st.group_ranges, st.alpha_logits, pol.a_bit, pol.w_bit,
                                                     symmetric=symmetric, mse_search=mse_search, **extras)
        runtime[name] = Int8Layer(gq, ws, wzp, zc, scale, zp)
    return runtime


def make_int8_conv_apply(runtime: Dict[str, Int8Layer], qunet, qstates: Dict[str, ActQuantState], step_idx: int,
                         symmetric: bool = True, plain: bool = False):
    """The conv interceptor of the interception runtime at `step_idx`: a
    conv in the fold runs `quantized_conv2d_int8_prefolded` on its step's
    fold (`symmetric` as the fold was made); the others (conv_in, the
    stride-2 downsample, narrow convs) fake-quantize their input and keep
    their float weights, the standard keep-first-and-last policy.  Pass the
    float params to `unet_apply`.  `plain=True` runs K1's plain version."""

    def conv_apply(name, x, p, *, stride=1, padding="SAME"):
        rt, pol = runtime.get(name), qunet.policy.get(name)
        if rt is not None and stride == 1:
            return quantized_conv2d_int8_prefolded(
                x.to(torch.float32), None, rt.ws[step_idx], rt.wzp[step_idx], rt.zcorr[step_idx],
                p["bias"].to(torch.float32), rt.act_scale[step_idx], rt.act_zp[step_idx], pol.a_bit,
                p["kernel"].shape[0], p["kernel"].shape[3], symmetric=symmetric, gqt=rt.gqt[step_idx],
                plain=plain).to(x.dtype)
        if pol is not None and name in qstates:
            xq = quantize_activation(x.to(torch.float32), qstates[name], step_idx, pol.a_bit)
            return conv2d(xq.to(p["kernel"].dtype), p, stride=stride, padding=padding)
        return conv2d(x, p, stride=stride, padding=padding)

    return conv_apply


def int8_model_fn(qunet, runtime: Dict[str, Int8Layer], params, qstates: Dict[str, ActQuantState],
                  symmetric: bool = True, plain: bool = False):
    """Sampler-compatible `(x, t, step_idx) -> eps` closure over the
    interception runtime (`make_int8_conv_apply`).  Pass the float params:
    eligible convs read the folded int8 weights of `runtime`, the rest keep
    their float weights."""

    def fn(x, t, step_idx):
        ca = make_int8_conv_apply(runtime, qunet, qstates, step_idx, symmetric=symmetric, plain=plain)
        return unet_apply(params, qunet.cfg, x, t, conv_apply=ca)

    return fn
