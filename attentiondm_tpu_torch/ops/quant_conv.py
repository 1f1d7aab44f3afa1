"""The int8 conv of the interception runtime and the per-step weight fold
(port of `attentiondm_tpu/ops/quant_conv.py`).

Math (q = round(s*x - zp) => x_hat = (q + zp)/s):

    O[m,n] = sum_k x_hat[m,k] * w[k,n]
           = (DOT_int32[m,n] + wzp_n * ROWSUM[m]) / ws_n + ZCORR[n]

where g[k,n] = w[k,n]/s_c(k) has the per-channel activation scales folded
in, (gq, ws, wzp) is g's per-output-channel w_bit quantization, ROWSUM[m] =
sum_k xq[m,k] and ZCORR[n] = sum_k zp_c(k) * g_hat[k,n].  Symmetric weights
(wzp = 0) drop the rowsum term: the serving path's folds.

Fold layout: gq [kh*kw*Cp, Np] int8 with rows in (dy, dx, c) order and the
channel axes zero-padded to multiples of 128 — the operand layout of the
int8 conv kernel (ops/pallas_conv.py).  The TPU module's two kernels are
that kernel's int32 modes here: `int8_matmul` (K5, JAX's `int8_matmul`) is
its 1x1 mode over the flat rows, `conv3x3_int8_dot` (K13, JAX's
`_conv3x3_int8_dot`) its 3x3 mode; both launch K1 on a CUDA tensor and run
its plain version on a CPU one.  The rowsum is an exact integer sum in plain
torch: for a 3x3 conv the 3x3 box sum of each pixel's channel sum over the
halo'd input, as JAX's `reduce_window`.
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


def _grid(g, symmetric: bool, shrink):
    """The grid's per-output-channel span (max |g|, or max(g) - min(g) with
    0 inside) times the shrink, and its low end (None when symmetric)."""
    axes = tuple(range(g.ndim - 1))
    if symmetric:
        return torch.clamp(g.abs().amax(dim=axes), min=1e-8) * shrink, None
    g_min = torch.clamp(g.amin(dim=axes), max=0.0) * shrink
    return torch.clamp(g.amax(dim=axes), min=1e-8) * shrink - g_min, g_min


def grid_span(g, w_bit: int, symmetric: bool, shrink=1.0):
    """(levels, span) of the per-output-channel grid of scale-folded weights
    `g`: ws = levels / span, levels 2^(w_bit-1) - 1 and span max |g| * shrink
    when symmetric, else 2^w_bit - 1 over the span of [min(g, 0), max(g)]
    times the shrink."""
    span, _ = _grid(g, symmetric, shrink)
    return (2 ** (w_bit - 1) - 1 if symmetric else 2 ** w_bit - 1), span


def weight_grid(g, w_bit: int, symmetric: bool, shrink=1.0):
    """Per-output-channel grid (ws, wzp) of scale-folded weights `g` (last
    axis = out channels; every other axis reduces)."""
    n = 2 ** (w_bit - 1)
    span, g_min = _grid(g, symmetric, shrink)
    if symmetric:
        ws = div(n - 1, span)
        return ws, torch.zeros_like(ws)
    ws = div(2 ** w_bit - 1, span)
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


def fold_weights_int8(kernel, act_scale, w_bit: int, symmetric: bool = False, shrink=None, round_offset=None):
    """Fold per-input-channel activation scales into the HWIO kernel and
    quantize per output channel at w_bit.

    `round_offset` [kh, kw, ci, co] (int16: GPTQ's offsets are signed and can
    be several levels; AdaRound's are 0 / 1) replaces round-to-nearest:
    q = clip(floor(ws*g - wzp) + round_offset).

    Returns (gq int8 [kh*kw*Cp, Np], ws [Np], wzp [Np], g_hat f32
    [kh*kw*Cp, Np]), K and N zero-padded to multiples of 128 (ws pads with 1)."""
    kh, kw, ci, co = kernel.shape
    g = kernel / act_scale.reshape(1, 1, ci, 1)
    n = 2 ** (w_bit - 1)
    if shrink is None:
        shrink = 1.0
    ws, wzp = weight_grid(g, w_bit, symmetric, shrink)
    if round_offset is None:
        gq = torch.clamp(torch.round(ws * g - wzp), -n, n - 1)
    else:
        gq = torch.clamp(torch.floor(ws * g - wzp) + round_offset.to(g.dtype), -n, n - 1)
    g_hat = (gq + wzp) / ws
    Cp, Np = _round_up(ci, 128), _round_up(co, 128)
    pad = (0, Np - co, 0, Cp - ci)
    gq = F.pad(gq, pad)
    g_hat = F.pad(g_hat, pad)
    ws = F.pad(ws, (0, Np - co), value=1.0)
    wzp = F.pad(wzp, (0, Np - co))
    return gq.reshape(kh * kw * Cp, Np).to(torch.int8), ws, wzp, g_hat.reshape(kh * kw * Cp, Np)


def int8_matmul_ref(xq, wq):
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exact: a float64 product
    (every |sum| here is far below 2^53; torch has no CUDA integer matmul,
    and on the CPU float64 is about 8x faster than int32).  The plain
    version of the TPU's int8 matmul K5."""
    return (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)


def zcorr_from_fold(g_hat, act_zp, ksize: int, C: int):
    """ZCORR[n] = sum_k zp_c(k) * g_hat[k, n] for a folded weight matrix."""
    Cp = g_hat.shape[0] // (ksize * ksize)
    zp_pad = F.pad(act_zp, (0, Cp - C))
    return zp_pad.repeat(ksize * ksize) @ g_hat


# ---------------------------------------------------------------------------
# the interception runtime's int8 conv (K5 and K13 through K1)
# ---------------------------------------------------------------------------


def int8_matmul(xq, wq, *, wqt=None, plain: bool = False):
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32 (JAX's K5 `int8_matmul`):
    K1's 1x1 mode over M flat rows.  K and N are multiples of 128 (the fold
    pads them); `wqt` [N, K] is the K-major copy the kernel reads (made per
    call where not given)."""
    from .pallas_conv import int8_conv

    M, K = xq.shape
    return int8_conv(xq.reshape(1, M, 1, K), wq, ksize=1, gqt=wqt, plain=plain).reshape(M, -1)


def conv3x3_int8_dot(xq_padded, wq, *, wqt=None, plain: bool = False):
    """3x3 int8 conv of a halo'd [B, H + 2, W + 2, Cp] input with the fold's
    [9 Cp, N] weights -> int32 [B * H * W, N] (JAX's K13 `_conv3x3_int8_dot`):
    K1's 3x3 int32 mode."""
    from .pallas_conv import int8_conv

    out = int8_conv(xq_padded, wq, ksize=3, gqt=wqt, plain=plain)
    return out.reshape(-1, out.shape[-1])


def _quantize_padded(x, act_scale, act_zp, a_bit: int, ksize: int, Cp: int):
    """x [B, H, W, C] float, zero-padded by 1 for a 3x3 conv BEFORE it is
    quantized (the halo lands on each channel's quantized zero), quantized
    at (act_scale, act_zp) and channel-padded with 0 codes to Cp: int8."""
    n = 2 ** (a_bit - 1)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)) if ksize == 3 else x
    xq = torch.clamp(torch.round(act_scale * xp - act_zp), -n, n - 1)
    return F.pad(xq, (0, Cp - x.shape[-1])).to(torch.int8)


def _rowsum(xq, ksize: int):
    """ROWSUM of every output row, exact int32: the channel sum of each
    pixel, and for a 3x3 conv the 3x3 box sum of those over the halo'd input
    (nine shifted integer adds)."""
    chan = xq.to(torch.int32).sum(dim=-1)  # [B, Hp, Wp]
    if ksize == 1:
        return chan.reshape(-1)
    H, W = chan.shape[1] - 2, chan.shape[2] - 2
    box = torch.zeros((chan.shape[0], H, W), dtype=torch.int32, device=chan.device)
    for dy in range(3):
        for dx in range(3):
            box += chan[:, dy:dy + H, dx:dx + W]
    return box.reshape(-1)


def _dequant(dot, ws, wzp, zcorr, rowsum, symmetric: bool):
    """(dot + wzp * rowsum) / ws + zcorr per output row and column, in f32
    (JAX's order; symmetric folds drop the rowsum term)."""
    out = dot.to(torch.float32)
    if not symmetric:
        out = out + wzp[None, :] * rowsum[:, None].to(torch.float32)
    return out / ws[None, :] + zcorr[None, :]


def quantized_conv2d_int8_prefolded(x, gq, ws, wzp, zcorr, bias, act_scale, act_zp, a_bit: int, ksize: int,
                                    co: int, *, symmetric: bool = False, gqt=None, plain: bool = False):
    """int8 conv with weights already folded and quantized (the interception
    sampler's per-step path: `quant/int8_runtime.make_int8_conv_apply`).

    x [B, H, W, C] float (SAME padding for 3x3, stride 1); gq [kh*kw*Cp, Np]
    int8 (or its K-major copy `gqt`, which the kernel reads); ws, wzp, zcorr
    [Np]; bias [co]; act_scale, act_zp [C].  The product is K13 (3x3) or K5
    (1x1) on K1; with `symmetric=True` (wzp == 0) the rowsum and its term
    are skipped.  Returns float32 [B, H, W, co]."""
    if ksize not in (1, 3):
        raise ValueError(f"quantized_conv2d_int8_prefolded: ksize={ksize} (1 or 3)")
    B, H, W, _C = x.shape
    Np = gq.shape[1] if gq is not None else gqt.shape[0]
    Cp = (gq.shape[0] if gq is not None else gqt.shape[1]) // (ksize * ksize)
    xq = _quantize_padded(x, act_scale, act_zp, a_bit, ksize, Cp)
    if ksize == 3:
        dot = conv3x3_int8_dot(xq, gq, wqt=gqt, plain=plain)
    else:
        dot = int8_matmul(xq.reshape(-1, Cp), gq, wqt=gqt, plain=plain)
    rowsum = None if symmetric else _rowsum(xq, ksize)
    out = _dequant(dot, ws, wzp, zcorr, rowsum, symmetric)
    return out.reshape(B, H, W, Np)[..., :co] + bias


def quantized_conv2d_int8(x, kernel, bias, act_min, act_max, a_bit: int, w_bit: int, *, stride: int = 1,
                          plain: bool = False):
    """The whole quantized conv, folded per call: per-channel asymmetric
    activation quantization at a_bit over [act_min, act_max] ([C], e.g.
    `quant.state.mixed_ranges`), the activation scales folded into the
    kernel and quantized per output channel at w_bit with an asymmetric
    grid, int8 products on K1 (K13 for 3x3, K5 for 1x1), the rowsum and
    zero-point terms in f32.  x [B, H, W, C] float (SAME padding), stride 1:
    JAX refuses a strided 3x3 and ignores the stride of a 1x1, so both raise
    ValueError here.  Returns float32 [B, H, W, co]."""
    kh, kw, ci, co = kernel.shape
    if x.shape[-1] != ci:
        raise ValueError(f"quantized_conv2d_int8: x has {x.shape[-1]} channels, the kernel {ci}")
    if stride != 1 or kh != kw or kh not in (1, 3):
        raise ValueError(f"quantized_conv2d_int8: a {kh}x{kw} kernel at stride {stride} (1x1 or 3x3 at stride 1)")
    s = div(2 ** a_bit - 1, act_max - act_min)
    zp = torch.round(s * act_min) + 2 ** (a_bit - 1)
    gq, ws, wzp, g_hat = fold_weights_int8(kernel, s, w_bit)
    zcorr = zcorr_from_fold(g_hat, zp, kh, ci)
    return quantized_conv2d_int8_prefolded(x, gq, ws, wzp, zcorr, bias, s, zp, a_bit, kh, co, symmetric=False,
                                           plain=plain)
