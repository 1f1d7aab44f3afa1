"""K2 and K6: the resblock's fused conv1 epilogue -> +temb -> GroupNorm ->
swish -> int8 quant (port of `attentiondm_tpu/ops/fused_gn.epilogue_gn_swish_quant`
and `epilogue_gn_swish_quant_blocked`).

One pass from conv1's output (bf16 already dequantized, or the int32
accumulator with `inv_ws` / `zcbias`) to conv2's int8 input; the float32
intermediate never reaches device memory.  `epilogue_gn_swish_quant`
routes by JAX's own predicate: images within the TPU kernel's whole-image
budget take K2 (`epilogue_gn_swish_quant_whole`, csrc/fused_gn.cu, one
block per image), larger ones on the 128-channel grid take K6
(`epilogue_gn_swish_quant_blocked`, csrc/fused_gn_blocked.cu, two passes
over chunks of 1024 rows), and the rest raise.

GroupNorm statistics follow the TPU kernel's `_gn_normalize`: per-group
sum and sum of squares in float32, variance E[x^2] - mu^2 clamped at 0
(not torch's two-pass `var`).  The float32 sums run in one fixed order,
`window_sum`'s, in the kernels and here alike, so kernel and plain version
give the same bits (csrc/common.cuh).  Swish is written
`h * (1 / (1 + exp(-h)))`, the kernel's formula.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..quant.primitives import div
from . import _build

GROUPS = 32  # the UNet's GroupNorm (eps 1e-6)
WIN = 32  # rows per window of the float32 sums (csrc/common.cuh GN_WIN)
CHUNK = WIN * WIN  # rows per K6 block (GN_CHUNK)
WHOLE_IMAGE_BYTES = 4 * 1024 * 1024  # JAX's whole-image budget for K2: HW * N * (in bytes + 1)
_ROADMAP = "ROADMAP Queue 1, 'the enhanced variant and the remaining serving flags'"


def _seq_sum(x, dim: int):
    """Sum along `dim` in index order, one float32 add at a time."""
    x = x.movedim(dim, 0)
    s = x[0]
    for i in range(1, x.shape[0]):
        s = s + x[i]
    return s


def window_sum(x):
    """[..., n, C] -> [..., C] float32 sum over rows in the windowed order
    of XLA's CPU reduction: windows of 32 consecutive rows summed in
    sequence, then the window sums the same way, until at most 32 remain,
    which add in sequence.  The kernels sum in this order (csrc/common.cuh)."""
    while x.shape[-2] > WIN:
        n = x.shape[-2]
        m = -(-n // WIN)
        x = F.pad(x, (0, 0, 0, m * WIN - n))
        x = _seq_sum(x.reshape(*x.shape[:-2], m, WIN, x.shape[-1]), -2)
    return _seq_sum(x, -2)


def _finalize(s_g, s2_g, inv_count: float):
    mean_g = s_g * inv_count
    var_g = torch.clamp(s2_g * inv_count - mean_g * mean_g, min=0.0)
    return mean_g, div(1.0, torch.sqrt(var_g + 1e-6))


def _normalize(x, mean_g, rstd_g, gn_scale, gn_bias):
    cg = x.shape[-1] // mean_g.shape[-1]
    mean_c = mean_g.repeat_interleave(cg, dim=-1)[:, None, :]
    rstd_c = rstd_g.repeat_interleave(cg, dim=-1)[:, None, :]
    return (x - mean_c) * rstd_c * gn_scale + gn_bias


def gn_normalize(x, gn_scale, gn_bias):
    """x [B, HW, C] float32 -> GroupNorm(x) with E[x^2]-mu^2 statistics,
    summed per channel by `window_sum`, then per group in channel order."""
    B, HW, C = x.shape
    g = min(GROUPS, C)
    cg = C // g
    s_g = _seq_sum(window_sum(x).reshape(B, g, cg), -1)
    s2_g = _seq_sum(window_sum(x * x).reshape(B, g, cg), -1)
    mean_g, rstd_g = _finalize(s_g, s2_g, 1.0 / (HW * cg))
    return _normalize(x, mean_g, rstd_g, gn_scale, gn_bias)


def swish(h):
    return h * div(1.0, 1.0 + torch.exp(-h))


def quant_i8(x, scale, zp, a_bit: int):
    n = 2 ** (a_bit - 1)
    return torch.clamp(torch.round(scale * x - zp), -n, n - 1).to(torch.int8)


def _epilogue_h(dot, inv_ws, zcbias, temb):
    B, N = dot.shape[0], dot.shape[-1]
    h = dot.to(torch.float32).reshape(B, -1, N) * inv_ws + zcbias
    return h + temb.to(torch.float32)[:, None, :]


def epilogue_gn_swish_quant_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                act_zp, a_bit: int):
    """Plain version of K2."""
    h = gn_normalize(_epilogue_h(dot, inv_ws, zcbias, temb), gn_scale.float(), gn_bias.float())
    return quant_i8(swish(h), act_scale, act_zp, a_bit).reshape(dot.shape)


def epilogue_gn_swish_quant_blocked_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                        act_zp, a_bit: int):
    """Plain version of K6, in its order: per chunk of CHUNK rows the
    channel sums (`window_sum`) and their group sums, then the chunks' group
    sums in chunk order."""
    h = _epilogue_h(dot, inv_ws, zcbias, temb)
    B, HW, N = h.shape
    g = min(GROUPS, N)
    cg = N // g
    nchunk = -(-HW // CHUNK)
    hc = F.pad(h, (0, 0, 0, nchunk * CHUNK - HW)).reshape(B, nchunk, CHUNK, N)
    s_g = _seq_sum(_seq_sum(window_sum(hc).reshape(B, nchunk, g, cg), -1), 1)
    s2_g = _seq_sum(_seq_sum(window_sum(hc * hc).reshape(B, nchunk, g, cg), -1), 1)
    mean_g, rstd_g = _finalize(s_g, s2_g, 1.0 / (HW * cg))
    h = _normalize(h, mean_g, rstd_g, gn_scale.float(), gn_bias.float())
    return quant_i8(swish(h), act_scale, act_zp, a_bit).reshape(dot.shape)


def epilogue_route(shape, dtype) -> str:
    """Which kernel takes a conv1 output of this shape: "K2" or "K6", by the
    JAX dispatcher's predicate (`attentiondm_tpu/ops/fused_gn.py`
    epilogue_gn_swish_quant).  Shapes JAX sends to its XLA reference raise."""
    N = shape[-1]
    HW = 1
    for d in shape[1:-1]:
        HW *= d
    itemsize = torch.empty((), dtype=dtype).element_size()
    if HW * N * (itemsize + 1) <= WHOLE_IMAGE_BYTES:
        return "K2"
    if N % 128 == 0 and HW % 8 == 0:
        return "K6"
    raise NotImplementedError(
        f"epilogue_gn_swish_quant: HW={HW}, N={N} is over the whole-image budget and off the blocked "
        f"kernel's grid (N % 128, HW % 8), where JAX runs its XLA reference; not ported ({_ROADMAP})")


def _vectors(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp):
    vecs = [v.to(torch.float32).contiguous() for v in (inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp)]
    dot = dot.contiguous()
    return dot, vecs


def epilogue_gn_swish_quant(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                            a_bit: int, *, plain: bool = False):
    """dot [B, H, W, N] (bf16 or int32) -> int8 [B, H, W, N] input of the next
    conv; temb [B, N] is the time-embedding projection added before the
    statistics.  Routes to K2 or K6 (`epilogue_route`); `plain=True` runs
    the chosen kernel's plain version on any device."""
    if dot.dtype not in (torch.bfloat16, torch.int32):
        raise NotImplementedError(f"epilogue_gn_swish_quant: dot dtype {dot.dtype}")
    kernel = {"K2": epilogue_gn_swish_quant_whole, "K6": epilogue_gn_swish_quant_blocked}
    return kernel[epilogue_route(dot.shape, dot.dtype)](dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                                         act_zp, a_bit, plain=plain)


def epilogue_gn_swish_quant_whole(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                                  a_bit: int, *, plain: bool = False):
    """K2: `epilogue_gn_swish_quant`, one block per image, at any shape it
    takes (N dividing 512, HW up to 32 * 32 * CHUNK rows).  The serving path
    reaches it through the router; called directly it also runs at K6's
    shapes, for comparing the two.  `plain=True` runs the plain version on
    any device."""
    args = (dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp, a_bit)
    if plain or dot.device.type == "cpu":
        return epilogue_gn_swish_quant_ref(*args)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    g = min(GROUPS, N)
    if dot.dtype not in (torch.bfloat16, torch.int32) or N % g or 512 % N or HW > WIN * WIN * CHUNK:
        raise NotImplementedError(
            f"epilogue_gn_swish_quant_whole: {dot.dtype}, N={N}, HW={HW} (K2 takes bf16 or int32, N "
            f"dividing 512 and HW <= {WIN * WIN * CHUNK})")
    dot, vecs = _vectors(*args[:-1])
    _build.require_cuda("epilogue_gn_swish_quant_whole", dot, *vecs)
    out = torch.empty(dot.shape, dtype=torch.int8, device=dot.device)
    err = _build.kernels().adm_epilogue_gn_swish_quant(
        dot.data_ptr(), int(dot.dtype == torch.int32), *(v.data_ptr() for v in vecs), out.data_ptr(),
        B, HW, N, g, 2 ** (a_bit - 1), 1.0 / (HW * (N // g)), _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_gn_swish_quant")
    epilogue_gn_swish_quant_whole.launches += 1
    return out


epilogue_gn_swish_quant_whole.launches = 0


def epilogue_gn_swish_quant_blocked(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                                    a_bit: int, *, plain: bool = False):
    """K6: `epilogue_gn_swish_quant` for images over the whole-image budget
    (N a multiple of 128): a statistics pass and an apply pass over chunks
    of CHUNK rows, one launch count per call.  `plain=True` runs the plain
    version on any device."""
    if plain or dot.device.type == "cpu":
        return epilogue_gn_swish_quant_blocked_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias,
                                                   act_scale, act_zp, a_bit)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    if dot.dtype not in (torch.bfloat16, torch.int32) or N % 128 or N > 1024:
        raise NotImplementedError(
            f"epilogue_gn_swish_quant_blocked: {dot.dtype}, N={N} (K6 takes bf16 or int32, N a "
            f"multiple of 128 up to 1024)")
    g = min(GROUPS, N)
    dot, vecs = _vectors(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp)
    _build.require_cuda("epilogue_gn_swish_quant_blocked", dot, *vecs)
    partial = torch.empty((B, -(-HW // CHUNK), 2, g), dtype=torch.float32, device=dot.device)
    out = torch.empty(dot.shape, dtype=torch.int8, device=dot.device)
    err = _build.kernels().adm_epilogue_gn_swish_quant_blocked(
        dot.data_ptr(), int(dot.dtype == torch.int32), *(v.data_ptr() for v in vecs), partial.data_ptr(),
        out.data_ptr(), B, HW, N, g, 2 ** (a_bit - 1), 1.0 / (HW * (N // g)), _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_gn_swish_quant_blocked")
    epilogue_gn_swish_quant_blocked.launches += 1
    return out


epilogue_gn_swish_quant_blocked.launches = 0
