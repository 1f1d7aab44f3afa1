"""K2: the resblock's fused conv1 epilogue -> +temb -> GroupNorm -> swish ->
int8 quant (port of `attentiondm_tpu/ops/fused_gn.epilogue_gn_swish_quant`).

One pass from conv1's output (bf16 already dequantized, or the int32
accumulator with `inv_ws` / `zcbias`) to conv2's int8 input; the float32
intermediate never reaches device memory.  CUDA kernel: csrc/fused_gn.cu.

GroupNorm statistics follow the TPU kernel's `_gn_normalize`: per-group
sum and sum of squares, variance E[x^2] - mu^2 clamped at 0 (not torch's
two-pass `var`), all float32.  The sums accumulate in float64 and round
once to float32, in the kernel and here alike, so neither depends on its
summation order and the two give the same bits (csrc/common.cuh says why
that matters).  Swish is written `h * (1 / (1 + exp(-h)))`, the kernel's
formula.
"""
from __future__ import annotations

import torch

from ..quant.primitives import div
from . import _build

GROUPS = 32  # the UNet's GroupNorm (eps 1e-6)


def gn_normalize(x, gn_scale, gn_bias):
    """x [B, HW, C] float32 -> GroupNorm(x) with E[x^2]-mu^2 statistics."""
    B, HW, C = x.shape
    g = min(GROUPS, C)
    cg = C // g
    inv_count = 1.0 / (HW * cg)
    xd = x.to(torch.float64).reshape(B, HW, g, cg)
    s_g = xd.sum(dim=(1, 3)).to(torch.float32)
    s2_g = (xd * xd).sum(dim=(1, 3)).to(torch.float32)
    mean_g = s_g * inv_count
    var_g = torch.clamp(s2_g * inv_count - mean_g * mean_g, min=0.0)
    rstd_g = div(1.0, torch.sqrt(var_g + 1e-6))
    mean_c = mean_g.repeat_interleave(cg, dim=1)[:, None, :]
    rstd_c = rstd_g.repeat_interleave(cg, dim=1)[:, None, :]
    return (x - mean_c) * rstd_c * gn_scale + gn_bias


def swish(h):
    return h * div(1.0, 1.0 + torch.exp(-h))


def quant_i8(x, scale, zp, a_bit: int):
    n = 2 ** (a_bit - 1)
    return torch.clamp(torch.round(scale * x - zp), -n, n - 1).to(torch.int8)


def epilogue_gn_swish_quant_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                act_zp, a_bit: int):
    """Plain version of `epilogue_gn_swish_quant`."""
    B, N = dot.shape[0], dot.shape[-1]
    h = dot.to(torch.float32).reshape(B, -1, N) * inv_ws + zcbias
    h = h + temb.to(torch.float32)[:, None, :]
    h = gn_normalize(h, gn_scale.float(), gn_bias.float())
    return quant_i8(swish(h), act_scale, act_zp, a_bit).reshape(dot.shape)


def epilogue_gn_swish_quant(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                            a_bit: int, *, plain: bool = False):
    """dot [B, H, W, N] (bf16 or int32) -> int8 [B, H, W, N] input of the next
    conv; temb [B, N] is the time-embedding projection added before the
    statistics.  `plain=True` runs the plain version on any device."""
    if dot.dtype not in (torch.bfloat16, torch.int32):
        raise NotImplementedError(f"epilogue_gn_swish_quant: dot dtype {dot.dtype}")
    if plain or dot.device.type == "cpu":
        return epilogue_gn_swish_quant_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias,
                                           act_scale, act_zp, a_bit)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    g = min(GROUPS, N)
    if N % g or 512 % N:
        raise NotImplementedError(f"epilogue_gn_swish_quant: N={N} (the kernel takes N dividing 512)")
    vecs = [v.to(torch.float32).contiguous() for v in (inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp)]
    dot = dot.contiguous()
    _build.require_cuda("epilogue_gn_swish_quant", dot, *vecs)
    out = torch.empty(dot.shape, dtype=torch.int8, device=dot.device)
    err = _build.kernels().adm_epilogue_gn_swish_quant(
        dot.data_ptr(), int(dot.dtype == torch.int32), *(v.data_ptr() for v in vecs), out.data_ptr(),
        B, HW, N, g, 2 ** (a_bit - 1), 1.0 / (HW * (N // g)), _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_gn_swish_quant")
    epilogue_gn_swish_quant.launches += 1
    return out


epilogue_gn_swish_quant.launches = 0
