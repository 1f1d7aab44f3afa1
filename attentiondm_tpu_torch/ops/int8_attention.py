"""K3: the whole DDIM attention block with int8 projections (port of
`attentiondm_tpu/ops/int8_attention.fused_attention_block`).

residual -> GroupNorm -> three int8 quants -> int8 q/k/v 1x1 GEMMs +
dequant -> f32 softmax(q k^T * C^-1/2) v -> int8 quant -> int8 out-projection
+ dequant -> + residual, written at the residual's dtype (bf16).

On the TPU one program held whole images in VMEM.  One image's f32 logits
(L*L*4 B = 256 KB at L = 256) exceed a Hopper block's shared memory, so the
CUDA version (csrc/int8_attention.cu) is a short chain of launches behind
this one wrapper; its launch count is one per block.  The attention core
stays float32, as on the TPU without `attn_int8`: q.k, the softmax
denominator and p.v accumulate in float32, in the kernel and in the plain
version's einsums alike.  The two sum in different orders, so they agree to
float32 rounding (a rare int8 code of proj_out's input one step apart), not
to the bit; the GroupNorm in front sums in `fused_gn.window_sum`'s order in
both and agrees exactly.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_gn import GROUPS, gn_normalize, quant_i8
from .quant_conv import int8_matmul_ref


def fused_attention_block_ref(x, gn_scale, gn_bias, qkv_quant, qkv_weights, o_quant, o_weights,
                              *, scale: float):
    """Plain version of `fused_attention_block`, in the TPU kernel's order."""
    B, L, C = x.shape
    xf = x.to(torch.float32)
    h = gn_normalize(xf, gn_scale.float(), gn_bias.float()).reshape(B * L, C)
    q, k, v = (
        (int8_matmul_ref(quant_i8(h, s, z, b), gq).to(torch.float32) * iw + zc).reshape(B, L, C)
        for (s, z, b), (gq, iw, zc) in zip(qkv_quant, qkv_weights)
    )
    logits = torch.einsum("blc,bmc->blm", q, k) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    av = torch.einsum("blm,bmc->blc", p, v).reshape(B * L, C)
    so, zo, bo = o_quant
    gq_o, iw_o, zc_o = o_weights
    out = int8_matmul_ref(quant_i8(av, so, zo, bo), gq_o).to(torch.float32) * iw_o + zc_o
    return (xf + out.reshape(B, L, C)).to(x.dtype)


def fused_attention_block(x, gn_scale, gn_bias, qkv_quant, qkv_weights, o_quant, o_weights, *,
                          scale: float, plain: bool = False):
    """x [B, L, C] residual -> x + attention(x), at x's dtype.

    qkv_quant: [(act_scale [C], act_zp [C], a_bit)] * 3 for q, k, v;
    qkv_weights: [(gq [C, C] int8, inv_ws [C], zcbias [C])] * 3;
    o_quant / o_weights: the same for proj_out.  `plain=True` runs the plain
    version on any device."""
    B, L, C = x.shape
    for gq, _iw, _zc in list(qkv_weights) + [o_weights]:
        if tuple(gq.shape) != (C, C):
            raise ValueError(f"fused_attention_block: weights {tuple(gq.shape)} != ({C}, {C})")
    if plain or x.device.type == "cpu":
        return fused_attention_block_ref(x, gn_scale, gn_bias, qkv_quant, qkv_weights, o_quant,
                                         o_weights, scale=scale)
    if x.dtype != torch.bfloat16 or C not in (128, 256, 512) or L > 1024:
        raise NotImplementedError(
            f"fused_attention_block on CUDA: bf16 residual, C in (128, 256, 512), L <= 1024; got "
            f"{x.dtype}, C={C}, L={L} (larger maps take K10/K11, ROADMAP Queue 2)")
    g = min(GROUPS, C)
    f32 = dict(dtype=torch.float32, device=x.device)
    gn = torch.stack([gn_scale, gn_bias]).to(**f32)
    sqkv = torch.cat([torch.stack([s, z]) for (s, z, _b) in qkv_quant]).to(**f32)
    eqkv = torch.cat([torch.stack([iw, zc]) for (_gq, iw, zc) in qkv_weights]).to(**f32)
    so, zo, bo = o_quant
    gq_o, iw_o, zc_o = o_weights
    sqo = torch.stack([so, zo, iw_o, zc_o]).to(**f32)
    (wq, _, _), (wk, _, _), (wv, _, _) = qkv_weights
    x = x.contiguous()
    _build.require_cuda("fused_attention_block", x, gn, sqkv, eqkv, sqo, wq, wk, wv, gq_o)
    scratch8 = [torch.empty((B, L, C), dtype=torch.int8, device=x.device) for _ in range(4)]
    scratchf = [torch.empty((B, L, C), **f32) for _ in range(3)]
    out = torch.empty_like(x)
    err = _build.kernels().adm_fused_attention_block(
        x.data_ptr(), gn.data_ptr(), sqkv.data_ptr(),
        *(2 ** (b - 1) for (_s, _z, b) in qkv_quant),
        wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), eqkv.data_ptr(), sqo.data_ptr(),
        2 ** (bo - 1), gq_o.data_ptr(),
        *(t.data_ptr() for t in scratch8[:3]), *(t.data_ptr() for t in scratchf), scratch8[3].data_ptr(),
        out.data_ptr(), B, L, C, g, 1.0 / (L * (C // g)), float(scale), _build.stream_ptr(x.device))
    _build.check(err, "adm_fused_attention_block")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
