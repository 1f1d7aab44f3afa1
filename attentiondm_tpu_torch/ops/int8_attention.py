"""The int8 attention kernels of the serving path (port of
`attentiondm_tpu/ops/int8_attention.py`).

K3 `fused_attention_block`: the whole DDIM attention block, residual ->
GroupNorm -> three int8 quants -> int8 q/k/v 1x1 GEMMs + dequant -> softmax(q
k^T * C^-1/2) v -> int8 quant -> int8 out-projection + dequant -> + residual,
written at the residual's dtype (bf16).  It takes every map that
`fused_attention_block_fits` (JAX's VMEM cost model, kept as a pure routing
predicate) lets in.  On the TPU one program held whole images in VMEM.  One
image's f32 logits (L*L*4 B = 256 KB at L = 256) exceed a Hopper block's
shared memory, so the CUDA version (csrc/int8_attention.cu) is a short chain
of launches behind this one wrapper; its launch count is one per block.  Its
core is float32 by default: q.k, the softmax denominator and p.v accumulate
in float32.  With `int8_core` (the serving path's `attn_int8`) q and k are
re-quantized to int8 at per-image dynamic scales and the logits are an
integer product; softmax and p.v stay float32.

Larger maps take the composed branch of `quant/int8_serving._attn_fused`,
whose core is one of (csrc/int8_attn_core.cu):
  K8  `fused_int8_attention`: int32 q/k/v accumulators in, dynamic per-image
      int8 q and k, int8 logits, f32 softmax, bf16 p . bf16 v, int8 out at
      proj_out's quant parameters;
  K9  `fused_int8_attention_static`: int8 q/k/v at calibrated per-step scalar
      scales, the same core, `* sv` after p . v.  Images over JAX's budget
      (24*L*C > 6 MiB) on the 256 / 128 grids go on to K10, whose online
      softmax rounds differently, so the split is part of the result;
  K10 `int8_flash_attention_static`: K9's function with an online softmax
      over key blocks of 512 (snapped down to a divisor of L).
JAX sent the shapes its K8 / K9 programs could not hold (small, unaligned,
or over the budget off K10's grids) to plain tensor code.  The CUDA core
streams keys, so its limits are its own (`int8_core_takes`): on the card a
wrapper launches its kernel or raises, and the plain versions serve CPU
tensors and `plain=True` only.

Both CUDA cores run their products on the tensor cores: K3's by mma.sync, in
f32 by the 3xTF32 split (or s8 q.k in its int8 mode), K8 / K9 / K10's by
warpgroup wgmma in s8 and bf16.  Their launch geometry is computed here
(`core_plan`, `int8_core_plan`) and handed to the launcher, which refuses a
plan other than its own.

The kernels and their plain versions sum in different orders (the softmax
denominator, p.v; K3's f32 q.k), so they agree to float32 rounding (a rare
int8 code one step apart), not to the bit; the integer logits are exact in
both, and the GroupNorm in front of K3 sums in `fused_gn.window_sum`'s order
in both and agrees exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .attention import NEG_INF
from .fused_gn import GROUPS, gn_normalize, quant_i8
from .pallas_conv import conv_tiles, k_major
from .precision import exact_f32
from .quant_conv import int8_matmul_ref

FUSED_ATTN_VMEM_BUDGET = 6 * 1024 * 1024  # JAX's budget: it routes here, it sizes no CUDA block
FLASH_BLOCK_K = 512  # the key block of K10's online softmax, part of its result's last bits
_REF_LOGIT_BYTES = 1 << 29  # the plain versions hold at most this many bytes of L x L logits at once

SMEM_PER_BLOCK = 232448  # the dynamic shared memory one block can have on an H100 (227 KB)
CORE_WIDTHS = (128, 256, 512)  # the channel counts both CUDA cores are built for
K3_MAX_L = 1024  # K3's longest map: its GroupNorm pass holds one 1024-row chunk


class CorePlan(NamedTuple):
    """The launch geometry of K3's core (csrc/int8_attention.cu at_*): a
    block of `bq` queries x 8 warps; q / k chunks of `chunk` channels (128
    bytes a row) for 64 keys; p.v in passes of `cp` channels over v tiles of
    `vk` keys; `stages` ring stages; `smem` bytes (the block's logits
    [bq][lp + 4] f32 and the ring)."""
    bq: int
    lp: int
    chunk: int
    cp: int
    vk: int
    stages: int
    smem: int


K3_TWO_BLOCKS = 115712  # 113 KB: two such blocks, with 1 KB reserved each, fill an SM's 228 KB


def core_plan(L: int, C: int, int8_core: bool = False) -> CorePlan:
    """K3's core at an (L, C) map: 64 queries a block, 32 above L = 512 so
    that the logits fit; a warp holds 64 channels of p.v; as many ring
    stages (2 to 4) as leave room for two blocks an SM, so that short maps,
    whose few products cannot hide a load, keep more loads in flight."""
    lp = -(-L // 64) * 64
    bq = 64 if lp <= 512 else 32
    cp = min(C, 8 // (bq // 16) * 64)
    vk = 32 if cp <= 128 else 16
    stage = max((bq + 64) * (128 + 16), vk * (cp + 8) * 4)
    logits = bq * (lp + 4) * 4
    stages = min(4, max(2, (K3_TWO_BLOCKS - logits) // stage))
    return CorePlan(bq, lp, 128 if int8_core else 32, cp, vk, stages, logits + stages * stage)


class Int8CorePlan(NamedTuple):
    """The launch geometry of K8 / K9 / K10's core (csrc/int8_attn_core.cu
    ia_*): `bq` queries a block in row groups of 64, one warpgroup a row
    group and 128 channels (`threads`), 64-key K / V tiles in a ring of
    `stages`, `smem` bytes."""
    bq: int
    threads: int
    stages: int
    smem: int


def int8_core_plan(C: int) -> Int8CorePlan:
    """128 queries a block at C = 128 and 256, 64 at 512; 3 stages, 2 at C =
    512: 1024 bytes to align the swizzled tiles, Q [bq][C] int8, per stage K
    [64][C] int8 and V^T [C][64] bf16, and where C > 128 the row groups'
    exchange of maxima and sums."""
    wgs = C // 128
    bq = 64 if C == 512 else 128
    stages = 2 if C == 512 else 3
    exchange = 2 * bq * wgs * 4 if C > 128 else 0
    return Int8CorePlan(bq, bq // 64 * wgs * 128, stages, 1024 + bq * C + stages * 64 * 3 * C + exchange)


def k3_takes(L: int, C: int) -> bool:
    """Whether K3's CUDA chain takes an (L, C) map (with a bf16 residual)."""
    return C in CORE_WIDTHS and 1 <= L <= K3_MAX_L


def int8_core_takes(L: int, C: int) -> bool:
    """Whether the CUDA core of K8 / K9 / K10 takes an (L, C) map."""
    return C in CORE_WIDTHS and L > 0 and L % 64 == 0


def fused_attention_block_fits(L: int, C: int) -> bool:
    """Whether JAX's `_attn_fused` sends an (L, C) map to the whole-block
    kernel K3 (its VMEM cost model, the one place it lives)."""
    return C % 128 == 0 and L >= 8 and 6 * L * C * 4 + L * L * 4 <= FUSED_ATTN_VMEM_BUDGET


def static_core_takes_flash(L: int, C: int) -> bool:
    """JAX's dispatch of `fused_int8_attention_static`: whether an (L, C) map
    goes on to K10 (an image over its budget, on K10's grids) or stays with
    K9."""
    return L * C * 24 > FUSED_ATTN_VMEM_BUDGET and L % 256 == 0 and C % 128 == 0


def _dyn_quant_i8(x):
    """Per-image symmetric int8 of x [B, L, C]: (int8 codes, scale [B, 1, 1])."""
    absmax = x.abs().amax(dim=(1, 2), keepdim=True)
    s = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)  # a true division
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def _int8_logits(qq, kq):
    """int8 q . k^T as float32: exact (integers under 2^24 for C <= 1024), in
    float32 products with TF32 off."""
    with exact_f32():
        return torch.einsum("blc,bmc->blm", qq.to(torch.float32), kq.to(torch.float32))


def _pv_bf16(p, v):
    """bf16(p) . bf16(v) with float32 accumulation (bf16 products are exact in
    float32)."""
    with exact_f32():
        return torch.einsum("blm,bmc->blc", p.to(torch.bfloat16).to(torch.float32),
                            v.to(torch.bfloat16).to(torch.float32))


def _out_quant(out, out_scale, out_zp, a_bit: int):
    return quant_i8(out, out_scale.to(torch.float32), out_zp.to(torch.float32), a_bit)


def _softmax_cast_pv(lf, v):
    """max, exp, divide by the row sum, then the bf16 cast and p . v."""
    e = torch.exp(lf - lf.amax(dim=-1, keepdim=True))
    return _pv_bf16(e / e.sum(dim=-1, keepdim=True), v)


def _image_chunks(B: int, L: int):
    """Image ranges whose L x L float32 logits stay under `_REF_LOGIT_BYTES`."""
    n = max(1, _REF_LOGIT_BYTES // (L * L * 4))
    return [(i, min(i + n, B)) for i in range(0, B, n)]


def fused_int8_attention_reference(dotq, dotk, dotv, epi_q, epi_k, epi_v, out_scale, out_zp, a_bit: int, *,
                                   scale: float):
    """Plain version of K8: dynamic int8 logits, bf16 p . v, in the kernel's
    order."""
    outs = []
    for i, j in _image_chunks(dotq.shape[0], dotq.shape[1]):
        q, k, v = (d[i:j].to(torch.float32) * iw.to(torch.float32) + zc.to(torch.float32)
                   for d, (iw, zc) in ((dotq, epi_q), (dotk, epi_k), (dotv, epi_v)))
        (qq, sq), (kq, sk) = _dyn_quant_i8(q), _dyn_quant_i8(k)
        outs.append(_softmax_cast_pv(_int8_logits(qq, kq) * (sq * sk * scale), v))
    return _out_quant(torch.cat(outs), out_scale, out_zp, a_bit)


def fused_int8_attention_static_reference(qq, kq, vq, sq, sk, sv, out_scale, out_zp, a_bit: int, *, scale: float):
    """Plain version of K9."""
    ls = sq.to(torch.float32) * sk.to(torch.float32) * scale
    outs = [_softmax_cast_pv(_int8_logits(qq[i:j], kq[i:j]) * ls, vq[i:j]) * sv.to(torch.float32)
            for i, j in _image_chunks(qq.shape[0], qq.shape[1])]
    return _out_quant(torch.cat(outs), out_scale, out_zp, a_bit)


def _flash_block_k(L: int) -> int:
    """K10's key block: 512, snapped down to a divisor of L (256 at L = 2304)."""
    block_k = min(FLASH_BLOCK_K, L)
    while L % block_k:
        block_k //= 2
    return block_k


def int8_flash_attention_static_ref(qq, kq, vq, scalars, out_scale, out_zp, a_bit: int, *, scale: float):
    """Plain version of K10: the same key blocks in the same order."""
    B, L, C = qq.shape
    bk = _flash_block_k(L)
    sq, sk, sv = scalars.to(torch.float32).reshape(3).unbind()
    ls = sq * sk * scale
    acc = torch.zeros((B, L, C), dtype=torch.float32, device=qq.device)
    m = torch.full((B, L, 1), NEG_INF, dtype=torch.float32, device=qq.device)
    denom = torch.zeros_like(m)
    for i in range(L // bk):
        lf = _int8_logits(qq, kq[:, i * bk:(i + 1) * bk]) * ls
        m_new = torch.maximum(m, lf.amax(dim=-1, keepdim=True))
        p = torch.exp(lf - m_new)
        alpha = torch.exp(m - m_new)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _pv_bf16(p, vq[:, i * bk:(i + 1) * bk])
        m = m_new
    return _out_quant(acc / denom * sv, out_scale, out_zp, a_bit)


def _check_core(name: str, L: int, C: int, *tensors):
    if not int8_core_takes(L, C):
        raise NotImplementedError(f"{name} on CUDA: C in {CORE_WIDTHS} and L a multiple of 64; got C={C}, L={L}")
    _build.require_cuda(name, *tensors)


def _static_core(name, qq, kq, vq, scalars, out_scale, out_zp, a_bit, scale, bk, online):
    B, L, C = qq.shape
    qq, kq, vq = (a.contiguous() for a in (qq, kq, vq))
    sc = _build.f32c(scalars.reshape(3))
    osc, ozp = _build.f32c(out_scale), _build.f32c(out_zp)
    if any(a.dtype != torch.int8 for a in (qq, kq, vq)):
        raise ValueError(f"{name}: q, k and v must be int8")
    _check_core(name, L, C, qq, kq, vq, sc, osc, ozp)
    out = torch.empty_like(qq)
    vt = torch.empty((B, C, L), dtype=torch.bfloat16, device=qq.device)  # v^T in bf16, the p.v operand
    plan = int8_core_plan(C)
    err = _build.kernels().adm_int8_attention_static(
        qq.data_ptr(), kq.data_ptr(), vq.data_ptr(), sc.data_ptr(), osc.data_ptr(), ozp.data_ptr(),
        2 ** (a_bit - 1), vt.data_ptr(), out.data_ptr(), B, L, C, bk, int(online), float(scale), plan.bq,
        plan.stages, plan.smem, _build.stream_ptr(qq.device))
    _build.check(err, "adm_int8_attention_static")
    return out


def int8_flash_attention_static(qq, kq, vq, scalars, out_scale, out_zp, a_bit: int, *, scale: float,
                                plain: bool = False):
    """K10: the streaming int8 core for large maps.  qq, kq, vq [B, L, C]
    int8, scalars (sq, sk, sv), out_scale / out_zp [C] -> int8 [B, L, C]."""
    B, L, C = qq.shape
    if L % 256 or C % 128:
        raise ValueError(f"int8_flash_attention_static: L % 256 == 0 and C % 128 == 0, got L={L}, C={C}")
    if plain or qq.device.type == "cpu":
        return int8_flash_attention_static_ref(qq, kq, vq, scalars, out_scale, out_zp, a_bit, scale=scale)
    out = _static_core("int8_flash_attention_static", qq, kq, vq, scalars, out_scale, out_zp, a_bit, scale,
                       _flash_block_k(L), True)
    int8_flash_attention_static.launches += 1
    return out


int8_flash_attention_static.launches = 0


def fused_int8_attention_static(qq, kq, vq, sq, sk, sv, out_scale, out_zp, a_bit: int, *, scale: float,
                                plain: bool = False):
    """The static-scale core: K10 where `static_core_takes_flash`, else K9.
    qq, kq, vq [B, L, C] int8, scalar scales sq, sk, sv -> int8 [B, L, C]."""
    B, L, C = qq.shape
    scalars = torch.stack([sq, sk, sv]).to(torch.float32)
    if static_core_takes_flash(L, C):
        return int8_flash_attention_static(qq, kq, vq, scalars, out_scale, out_zp, a_bit, scale=scale, plain=plain)
    if plain or qq.device.type == "cpu":
        return fused_int8_attention_static_reference(qq, kq, vq, *scalars.unbind(), out_scale, out_zp, a_bit,
                                                     scale=scale)
    out = _static_core("fused_int8_attention_static", qq, kq, vq, scalars, out_scale, out_zp, a_bit, scale, L, False)
    fused_int8_attention_static.launches += 1
    return out


fused_int8_attention_static.launches = 0


def fused_int8_attention(dotq, dotk, dotv, epi_q, epi_k, epi_v, out_scale, out_zp, a_bit: int, *, scale: float,
                         plain: bool = False):
    """K8, the dynamic core: int32 projection accumulators [B, L, C] with
    their (inv_ws [C], zcbias [C]) in, proj_out's int8 input out."""
    B, L, C = dotq.shape
    if plain or dotq.device.type == "cpu":
        return fused_int8_attention_reference(dotq, dotk, dotv, epi_q, epi_k, epi_v, out_scale, out_zp, a_bit,
                                              scale=scale)
    dots = [d.contiguous() for d in (dotq, dotk, dotv)]
    if any(d.dtype != torch.int32 for d in dots):
        raise ValueError("fused_int8_attention: the projections must be int32 accumulators")
    epi = [_build.f32c(a) for pair in (epi_q, epi_k, epi_v) for a in pair]
    osc, ozp = _build.f32c(out_scale), _build.f32c(out_zp)
    _check_core("fused_int8_attention", L, C, *dots, *epi, osc, ozp)
    dev = dotq.device
    amax = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    q8, k8, out = (torch.empty((B, L, C), dtype=torch.int8, device=dev) for _ in range(3))
    vt = torch.empty((B, C, L), dtype=torch.bfloat16, device=dev)
    plan = int8_core_plan(C)
    err = _build.kernels().adm_fused_int8_attention(
        *(d.data_ptr() for d in dots), *(a.data_ptr() for a in epi), osc.data_ptr(), ozp.data_ptr(),
        2 ** (a_bit - 1), amax.data_ptr(), q8.data_ptr(), k8.data_ptr(), vt.data_ptr(), out.data_ptr(),
        B, L, C, float(scale), plan.bq, plan.stages, plan.smem, _build.stream_ptr(dev))
    _build.check(err, "adm_fused_int8_attention")
    fused_int8_attention.launches += 1
    return out


fused_int8_attention.launches = 0


def attention_core_ref(q, k, v, out_scale, out_zp, a_bit: int, *, scale: float, int8_core: bool = False,
                       logits: bool = False):
    """Plain version of K3's core: f32 q, k, v [B, L, C] -> proj_out's int8
    input, in the TPU kernel's order (and, with `logits`, the logits the
    softmax reads).  The f32 products run with TF32 off (`exact_f32`), so the
    yardstick does not hang on the global switch."""
    if int8_core:
        (qq, sq), (kq, sk) = _dyn_quant_i8(q), _dyn_quant_i8(k)
        lg = _int8_logits(qq, kq) * (sq * sk * scale)
    else:
        with exact_f32():
            lg = torch.einsum("blc,bmc->blm", q, k) * scale
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    with exact_f32():
        av = torch.einsum("blm,bmc->blc", p, v)
    o8 = quant_i8(av, out_scale.float(), out_zp.float(), a_bit)
    return (o8, lg) if logits else o8


def attention_core(q, k, v, out_scale, out_zp, a_bit: int, *, scale: float, int8_core: bool = False,
                   logits: bool = False, plain: bool = False):
    """K3's core alone (the third launch of `fused_attention_block`'s chain,
    through its own C entry point): f32 q, k, v [B, L, C] -> int8 [B, L, C]
    at proj_out's input quantization (out_scale, out_zp [C], a_bit).
    `logits=True` also returns the f32 logits [B, L, L] as the softmax reads
    them.  The serving path runs this kernel inside `fused_attention_block`;
    this wrapper is for measuring and testing the core on its own."""
    B, L, C = q.shape
    if plain or q.device.type == "cpu":
        return attention_core_ref(q, k, v, out_scale, out_zp, a_bit, scale=scale, int8_core=int8_core,
                                  logits=logits)
    if not k3_takes(L, C):
        raise NotImplementedError(f"attention_core on CUDA: C in {CORE_WIDTHS}, L <= {K3_MAX_L}; got C={C}, L={L}")
    q, k, v = (_build.f32c(a) for a in (q, k, v))
    sqo = torch.stack([out_scale, out_zp]).to(dtype=torch.float32, device=q.device)
    _build.require_cuda("attention_core", q, k, v, sqo)
    dev = q.device
    out = torch.empty((B, L, C), dtype=torch.int8, device=dev)
    lg = torch.empty((B, L, L), dtype=torch.float32, device=dev) if logits else None
    amax = q8 = k8 = None
    if int8_core:
        amax = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        q8, k8 = (torch.empty((B, L, C), dtype=torch.int8, device=dev) for _ in range(2))
    plan = core_plan(L, C, int8_core)
    err = _build.kernels().adm_attention_core(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(None if t is None else t.data_ptr() for t in (q8, k8, amax)),
        sqo.data_ptr(), 2 ** (a_bit - 1), out.data_ptr(), None if lg is None else lg.data_ptr(), B, L, C,
        plan.bq, plan.vk, plan.smem, float(scale), _build.stream_ptr(dev))
    _build.check(err, "adm_attention_core")
    attention_core.launches += 1
    return (out, lg) if logits else out


attention_core.launches = 0


def fused_attention_block_ref(x, gn_scale, gn_bias, qkv_quant, qkv_weights, o_quant, o_weights,
                              *, scale: float, int8_core: bool = False):
    """Plain version of `fused_attention_block`, in the TPU kernel's order."""
    B, L, C = x.shape
    xf = x.to(torch.float32)
    h = gn_normalize(xf, gn_scale.float(), gn_bias.float()).reshape(B * L, C)
    q, k, v = (
        (int8_matmul_ref(quant_i8(h, s, z, b), gq).to(torch.float32) * iw + zc).reshape(B, L, C)
        for (s, z, b), (gq, iw, zc) in zip(qkv_quant, qkv_weights)
    )
    so, zo, bo = o_quant
    o8 = attention_core_ref(q, k, v, so, zo, bo, scale=scale, int8_core=int8_core)
    gq_o, iw_o, zc_o = o_weights
    out = int8_matmul_ref(o8.reshape(B * L, C), gq_o).to(torch.float32) * iw_o + zc_o
    return (xf + out.reshape(B, L, C)).to(x.dtype)


def fused_attention_block(x, gn_scale, gn_bias, qkv_quant, qkv_weights, o_quant, o_weights, *,
                          scale: float, int8_core: bool = False, plain: bool = False):
    """x [B, L, C] residual -> x + attention(x), at x's dtype.

    qkv_quant: [(act_scale [C], act_zp [C], a_bit)] * 3 for q, k, v;
    qkv_weights: [(gq [C, C] int8, inv_ws [C], zcbias [C])] * 3, each
    optionally with a fourth entry, gq's K-major copy [C, C] (`gq.T`, which
    the kernel's GEMMs read; made on the fly where absent);
    o_quant / o_weights: the same for proj_out.  `int8_core` runs q . k^T in
    int8 at per-image dynamic scales.  `plain=True` runs the plain version on
    any device."""
    B, L, C = x.shape
    weights = [tuple(w) for w in (*qkv_weights, o_weights)]
    for w in weights:
        if any(tuple(g.shape) != (C, C) for g in (w[0], *w[3:])):
            raise ValueError(f"fused_attention_block: weights {tuple(w[0].shape)} != ({C}, {C})")
    if plain or x.device.type == "cpu":
        return fused_attention_block_ref(x, gn_scale, gn_bias, qkv_quant, [w[:3] for w in weights[:3]], o_quant,
                                         weights[3][:3], scale=scale, int8_core=int8_core)
    if x.dtype != torch.bfloat16 or not k3_takes(L, C):
        raise NotImplementedError(
            f"fused_attention_block on CUDA: bf16 residual, C in {CORE_WIDTHS}, L <= {K3_MAX_L}; got "
            f"{x.dtype}, C={C}, L={L} (larger maps fail `fused_attention_block_fits` and take the composed "
            f"branch of `_attn_fused`)")
    g = min(GROUPS, C)
    f32 = dict(dtype=torch.float32, device=x.device)
    gn = torch.stack([gn_scale, gn_bias]).to(**f32)
    sqkv = torch.cat([torch.stack([s, z]) for (s, z, _b) in qkv_quant]).to(**f32)
    eqkv = torch.cat([torch.stack([w[1], w[2]]) for w in weights[:3]]).to(**f32)
    so, zo, bo = o_quant
    sqo = torch.stack([so, zo, weights[3][1], weights[3][2]]).to(**f32)
    wq, wk, wv, wo = (w[3] if len(w) > 3 else k_major(w[0]) for w in weights)  # K-major
    x = x.contiguous()
    _build.require_cuda("fused_attention_block", x, gn, sqkv, eqkv, sqo, wq, wk, wv, wo)
    scratch8 = [torch.empty((B, L, C), dtype=torch.int8, device=x.device) for _ in range(4)]
    scratchf = [torch.empty((B, L, C), **f32) for _ in range(3)]
    out = torch.empty_like(x)
    amax = torch.zeros((B, 2), dtype=torch.int32, device=x.device) if int8_core else None
    tiles = conv_tiles(B, L, 1, 1, 1, C)  # the four projections: flat GEMMs over B * L rows
    plan = core_plan(L, C, int8_core)
    err = _build.kernels().adm_fused_attention_block(
        x.data_ptr(), gn.data_ptr(), sqkv.data_ptr(),
        *(2 ** (b - 1) for (_s, _z, b) in qkv_quant),
        wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), eqkv.data_ptr(), sqo.data_ptr(),
        2 ** (bo - 1), wo.data_ptr(),
        *(t.data_ptr() for t in scratch8[:3]), *(t.data_ptr() for t in scratchf), scratch8[3].data_ptr(),
        None if amax is None else amax.data_ptr(), out.data_ptr(), B, L, C, g, 1.0 / (L * (C // g)), float(scale),
        tiles.BM, tiles.cols, plan.bq, plan.vk, plan.smem, _build.stream_ptr(x.device))
    _build.check(err, "adm_fused_attention_block")
    fused_attention_block.launches += 1
    fused_attention_block.int8_core_launches += bool(int8_core)
    return out


fused_attention_block.launches = 0
fused_attention_block.int8_core_launches = 0  # the launches among them that ran the int8 core
