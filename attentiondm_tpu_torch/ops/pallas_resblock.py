"""K12: a whole identity-residual serving resblock behind one call (port of
`attentiondm_tpu/ops/pallas_resblock.resblock_pallas`).

    r -> GN1 -> swish -> quant -> conv1 (3x3 int8, quantized-zero halo) ->
    dequant -> +temb -> GN2 -> swish -> quant -> conv2 -> dequant -> + r

On the TPU one program held a batch block's whole working set in VMEM.  One
32 x 32 x 128 image is 256 KB in bf16 alone, over a Hopper block's shared
memory, so the CUDA version (csrc/resblock.cu) is a chain of four launches
behind this one wrapper, counted as one launch: K4's kernel into a halo'd
int8 buffer, K1's implicit GEMM (wgmma, reading the folds K-major) to int32,
the same GroupNorm kernel with K2's producer on that accumulator (float32
between conv1 and GroupNorm 2, as the TPU kernel) into a second halo'd
buffer, and the GEMM with a dequant + residual-add epilogue.  The residual
is bf16 or float32 (the float32 residual stream, JAX's default), read as it
is by the first launch and added by the last (K1's EPI_RESADD_BF16 or
EPI_RESADD_F32), the output at the same dtype.  The two GroupNorm launches
take `epilogue_plan(..., "K4", halo=True)`'s plans for the residual's dtype
and for int32 input (the image form, or past 32 windows the cluster form:
K4's blocked form writes dense rows), and write the halos' borders
themselves.  The
plain version composes the plain versions of the same stages, so its
float32 sums run in the same order and the two agree to the bit.

Eligible when cin == co1 == co2 (no shortcut) and C % 128 == 0;
`resblock_pallas_fits` is JAX's predicate over the TPU kernel's plan, kept
so the port routes the same blocks.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_gn import (
    GN_EPS,
    GROUPS,
    RESIDUAL_DTYPES,
    epilogue_gn_swish_quant_ref,
    epilogue_plan,
    gn_act_quant_ref,
    plan_args,
)
from .pallas_conv import conv_tiles, int8_conv_ref, k_major, pad_qzero

VMEM_BUDGET = 10 << 20  # the TPU kernel's plan


def _block_bt(B: int, H: int, W: int, C: int) -> int:
    g_b = 2 * 9 * C * C
    per = H * W * C * 7 + 2 * (H + 2) * (W + 2) * C + H * W * C * 4
    bt = max(1, int((VMEM_BUDGET - g_b) // max(per, 1)))
    bt = min(bt, B)
    while bt > 1 and B % bt:
        bt -= 1
    return bt if B % bt == 0 else 1


def resblock_pallas_fits(B: int, H: int, W: int, C: int) -> bool:
    """JAX's eligibility: channels on the 128 grid and the TPU kernel's
    plan (both folds, and per image of the batch block the bf16 residual, a
    float32 temporary, two halo'd int8 conv inputs and the int32
    accumulator) within its budget."""
    if C % 128 or B < 1:
        return False
    bt = _block_bt(B, H, W, C)
    per = H * W * C * (2 + 4 + 1) + 2 * (H + 2) * (W + 2) * C + H * W * C * 4
    return bt >= 1 and 2 * 9 * C * C + bt * per <= VMEM_BUDGET


def resblock_pallas_takes(B: int, H: int, W: int, C: int, dtype=torch.bfloat16) -> bool:
    """Whether K12's CUDA chain takes a [B, H, W, C] block with a `dtype`
    residual: bf16 or f32, C a multiple of 128 up to 1024, and launch plans
    for both GroupNorm launches."""
    if C % 128 or C > 1024 or dtype not in RESIDUAL_DTYPES:
        return False
    try:
        for d in (dtype, torch.int32):
            epilogue_plan(B, H * W, C, d, "K4", halo=True)
    except NotImplementedError:
        return False
    return True


def resblock_pallas_ref(r, tproj, gn1_scale, gn1_bias, q1, g1_flat, sb1, gn2_scale, gn2_bias, q2, g2_flat,
                        sb2, *, a_bit1: int = 8, a_bit2: int = 8, out_dtype=torch.bfloat16, eps: float = GN_EPS):
    """Plain version of K12: the plain versions of its stages, chained."""
    (hq,) = gn_act_quant_ref(r, gn1_scale, gn1_bias, [(q1[0], q1[1], a_bit1)], eps=eps)
    acc = int8_conv_ref(pad_qzero(hq, q1[1], a_bit1), g1_flat)
    hq2 = epilogue_gn_swish_quant_ref(acc, sb1[0], sb1[1], tproj, gn2_scale, gn2_bias, q2[0], q2[1], a_bit2, eps)
    acc = int8_conv_ref(pad_qzero(hq2, q2[1], a_bit2), g2_flat)
    return (r.to(torch.float32) + (acc.to(torch.float32) * sb2[0] + sb2[1])).to(out_dtype)


def resblock_pallas(r, tproj, gn1_scale, gn1_bias, q1, g1_flat, sb1, gn2_scale, gn2_bias, q2, g2_flat, sb2,
                    *, a_bit1: int = 8, a_bit2: int = 8, groups: int = GROUPS, out_dtype=torch.bfloat16,
                    g1_t=None, g2_t=None, eps: float = GN_EPS, plain: bool = False):
    """r [B, H, W, C] residual -> the resblock's output at `out_dtype`.

    tproj [B, C] float32 is dense(swish(temb)); gn*_scale / gn*_bias [C];
    q1, q2 = (act_scale [C], act_zp [C]) of conv1's and conv2's input;
    g1_flat, g2_flat [9C, C] int8 folded weights; sb1, sb2 = (inv_ws [C],
    zcbias [C]).  g1_t, g2_t [C, 9C]: the folds' K-major copies, which the
    kernel's GEMMs read (made on the fly where not given).  `plain=True` runs
    the plain version on any device."""
    B, H, W, C = r.shape
    if groups != GROUPS:
        raise NotImplementedError(f"resblock_pallas: groups={groups}")
    if tuple(g1_flat.shape) != (9 * C, C) or tuple(g2_flat.shape) != (9 * C, C):
        raise ValueError(f"resblock_pallas: folds {tuple(g1_flat.shape)}, {tuple(g2_flat.shape)} != ({9 * C}, {C})")
    if plain or r.device.type == "cpu":
        return resblock_pallas_ref(r, tproj, gn1_scale, gn1_bias, q1, g1_flat, sb1, gn2_scale, gn2_bias, q2,
                                   g2_flat, sb2, a_bit1=a_bit1, a_bit2=a_bit2, out_dtype=out_dtype, eps=eps)
    if (r.dtype != out_dtype or not resblock_pallas_takes(B, H, W, C, r.dtype)
            or g1_flat.dtype != torch.int8 or g2_flat.dtype != torch.int8):
        raise NotImplementedError(
            f"resblock_pallas on CUDA: a bf16 or f32 residual in and the same dtype out, int8 folds, C a multiple "
            f"of 128 up to 1024; got {r.dtype} -> {out_dtype}, C={C}")
    half1 = [_build.f32c(v, r.device) for v in (gn1_scale, gn1_bias, *q1, *sb1)]
    half2 = [_build.f32c(v, r.device) for v in (gn2_scale, gn2_bias, *q2, *sb2)]
    r, tproj = r.contiguous(), _build.f32c(tproj, r.device)
    g1_t = k_major(g1_flat) if g1_t is None else g1_t
    g2_t = k_major(g2_flat) if g2_t is None else g2_t
    _build.require_cuda("resblock_pallas", r, tproj, g1_t, g2_t, *half1, *half2)
    if tuple(g1_t.shape) != (C, 9 * C) or tuple(g2_t.shape) != (C, 9 * C):
        raise ValueError(f"resblock_pallas: K-major folds {tuple(g1_t.shape)}, {tuple(g2_t.shape)} != ({C}, {9 * C})")
    if any(v.numel() != C for v in half1 + half2) or tuple(tproj.shape) != (B, C):
        raise ValueError(f"resblock_pallas: per-channel vectors must hold {C} values and tproj be [{B}, {C}]")
    pad1, pad2 = (torch.empty((B, H + 2, W + 2, C), dtype=torch.int8, device=r.device) for _ in range(2))
    acc = torch.empty((B, H, W, C), dtype=torch.int32, device=r.device)
    out = torch.empty_like(r)
    g = min(GROUPS, C)
    t = conv_tiles(B, H, W, 3, 1, C)
    plan1, plan3 = (plan_args(epilogue_plan(B, H * W, C, dtype, "K4", halo=True)) for dtype in (r.dtype, torch.int32))
    err = _build.kernels().adm_resblock(
        r.data_ptr(), int(r.dtype == torch.float32), tproj.data_ptr(), _build.VEC6(*(v.data_ptr() for v in half1)), 2 ** (a_bit1 - 1),
        g1_t.data_ptr(), _build.VEC6(*(v.data_ptr() for v in half2)), 2 ** (a_bit2 - 1), g2_t.data_ptr(),
        pad1.data_ptr(), acc.data_ptr(), pad2.data_ptr(), out.data_ptr(),
        B, H, W, C, g, 1.0 / (H * W * (C // g)), eps, _build.TILE(t.BM, t.cols, t.rows, t.imgs), plan1, plan3,
        _build.stream_ptr(r.device))
    _build.check(err, "adm_resblock")
    resblock_pallas.launches += 1
    return out


resblock_pallas.launches = 0
