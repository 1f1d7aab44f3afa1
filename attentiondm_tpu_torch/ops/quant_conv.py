"""Host side of the int8 conv: the per-step weight fold (port of the fold
functions of `attentiondm_tpu/ops/quant_conv.py`).

Math (symmetric weights, q = round(s*x - zp) => x_hat = (q + zp)/s):

    O[m,n] = sum_k x_hat[m,k] * w[k,n] = DOT_int32[m,n] / ws_n + ZCORR[n]

where g[k,n] = w[k,n]/s_c(k) has the per-channel activation scales folded
in, (gq, ws) is g's per-output-channel w_bit quantization and
ZCORR[n] = sum_k zp_c(k) * g_hat[k,n].

Fold layout: gq [kh*kw*Cp, Np] int8 with rows in (dy, dx, c) order and the
channel axes zero-padded to multiples of 128 — the operand layout of the
int8 conv kernel (ops/pallas_conv.py).  The int8 matmul K5 and the int32
3x3 conv K13 of the JAX module are the conv kernel's ksize=1 and int32
modes there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..quant.primitives import div

# shrink grid: fine 1.00..0.55 (step 0.03) + a coarse tail for heavy-outlier
# channels (attentiondm_tpu/quant/state.WEIGHT_MSE_SHRINKS)
WEIGHT_MSE_SHRINKS = tuple(1.0 - 0.03 * i for i in range(16)) + (0.45, 0.35, 0.25, 0.15)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def weight_grid(g, w_bit: int, symmetric: bool, shrink=1.0):
    """Per-output-channel grid (ws, wzp) of scale-folded weights `g` (last
    axis = out channels; every other axis reduces)."""
    axes = tuple(range(g.ndim - 1))
    n = 2 ** (w_bit - 1)
    if symmetric:
        am = torch.clamp(g.abs().amax(dim=axes), min=1e-8) * shrink
        ws = div(n - 1, am)
        return ws, torch.zeros_like(ws)
    g_min = torch.clamp(g.amin(dim=axes), max=0.0) * shrink
    g_max = torch.clamp(g.amax(dim=axes), min=1e-8) * shrink
    ws = div(2 ** w_bit - 1, g_max - g_min)
    return ws, torch.round(ws * g_min) + n


def fold_shrink_search(kernel, act_scale, w_bit: int, symmetric: bool):
    """Per-output-channel MSE-optimal range shrink for g = kernel / act_scale,
    searched over WEIGHT_MSE_SHRINKS (first minimum wins)."""
    kh, kw, ci, co = kernel.shape
    g = kernel / act_scale.reshape(1, 1, ci, 1)
    n = 2 ** (w_bit - 1)
    ks = torch.tensor(WEIGHT_MSE_SHRINKS, dtype=g.dtype, device=g.device)
    errs = []
    for i in range(ks.shape[0]):
        ws_k, wzp_k = weight_grid(g, w_bit, symmetric, ks[i])
        q = torch.clamp(torch.round(ws_k * g - wzp_k), -n, n - 1)
        errs.append(torch.square((q + wzp_k) / ws_k - g).sum(dim=(0, 1, 2)))
    return ks[torch.argmin(torch.stack(errs), dim=0)]


def fold_weights_int8(kernel, act_scale, w_bit: int, symmetric: bool = False, shrink=None):
    """Fold per-input-channel activation scales into the HWIO kernel and
    quantize per output channel at w_bit.

    Returns (gq int8 [kh*kw*Cp, Np], ws [Np], wzp [Np], g_hat f32
    [kh*kw*Cp, Np]), K and N zero-padded to multiples of 128 (ws pads with 1)."""
    kh, kw, ci, co = kernel.shape
    g = kernel / act_scale.reshape(1, 1, ci, 1)
    n = 2 ** (w_bit - 1)
    if shrink is None:
        shrink = 1.0
    ws, wzp = weight_grid(g, w_bit, symmetric, shrink)
    gq = torch.clamp(torch.round(ws * g - wzp), -n, n - 1)
    g_hat = (gq + wzp) / ws
    Cp, Np = _round_up(ci, 128), _round_up(co, 128)
    pad = (0, Np - co, 0, Cp - ci)
    gq = F.pad(gq, pad)
    g_hat = F.pad(g_hat, pad)
    ws = F.pad(ws, (0, Np - co), value=1.0)
    wzp = F.pad(wzp, (0, Np - co))
    return gq.reshape(kh * kw * Cp, Np).to(torch.int8), ws, wzp, g_hat.reshape(kh * kw * Cp, Np)


def int8_matmul_ref(xq, wq):
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exact on either device: an
    int32 product on the CPU, float64 on the GPU (torch has no CUDA integer
    matmul; every |sum| here is far below 2^53).  The plain version of the
    TPU's int8 matmul K5."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq.to(torch.int32)
    return (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)


def zcorr_from_fold(g_hat, act_zp, ksize: int, C: int):
    """ZCORR[n] = sum_k zp_c(k) * g_hat[k, n] for a folded weight matrix."""
    Cp = g_hat.shape[0] // (ksize * ksize)
    zp_pad = F.pad(act_zp, (0, Cp - C))
    return zp_pad.repeat(ksize * ksize) @ g_hat
