"""Spatial attention of the FP UNet (port of `attentiondm_tpu/ops/attention.py`).

`spatial_attention` routes as the JAX package does: maps of L >= 1024 tokens
on the 256 / 128 grids (L % 256 == 0, D % 128 == 0) take K11
`flash_attention`, the online-softmax kernel that never holds an L x L
matrix (csrc/flash_attention.cu); shorter or unaligned maps take the dense
float32 softmax.  The FP teacher, stage-1 calibration and the serving
forward with `attn_int8=False` all come through here.

K11's order, in the kernel and in `flash_attention_ref` alike: q is scaled
before the dot; key blocks of `block_k` (512; the kernel splits a block into
inner blocks of 128 or 64 keys) stream with a running maximum
m (from -1e30), alpha = exp(m - m_new), denom = denom * alpha + sum(p) and
acc = acc * alpha + p . v; acc / denom at the end.  Kernel and plain version
sum their float32 dot products in different orders, so they agree to
rounding, not to the bit.

K11 has no backward, as JAX's Pallas kernel has none (`jax.grad` through it
fails to linearize): `flash_attention` raises where autograd would need one,
on the CPU as on the card, rather than return an output that carries no
gradient to q, k and v.

`head_attention` is ADM's multi-head core (models/adm.py): q, k, v [B, L,
heads * d], head h on channels [h d, (h + 1) d), softmax per head.  On the
card it is K11 with `heads` (one launch over (query block, image, head),
rows read at the stride of the whole width), at d = 64, 128 or 256 and any
L a multiple of 64; on the CPU the plain version of that launch.  It has no
backward either and raises as `flash_attention` does.
"""
from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30
FLASH_THRESHOLD = 1024  # JAX's `flash_threshold`


def takes_flash(L: int, D: int) -> bool:
    """JAX's dispatch of `spatial_attention`: whether an (L, D) map takes K11."""
    return L >= FLASH_THRESHOLD and L % 256 == 0 and D % 128 == 0


def flash_takes(L: int, D: int, block_k: int = 512, heads: int = 1) -> bool:
    """Whether K11's CUDA kernel takes an (L, D) map with key blocks of
    `block_k` (at most L): D of 128 or 256 (a head's D of 64, 128 or 256
    with `heads` > 1), L and the key block multiples of 64, the key block at
    most 512.  `flash_attention` launches on it and
    `ops.checks.attention_plan` names the sites it refuses before step 0."""
    bk = min(block_k, L)
    widths = (128, 256) if heads == 1 else (64, 128, 256)
    return D in widths and L % 64 == 0 and bk % 64 == 0 and bk <= 512


def _blocks(L: int, block_q: int, block_k: int):
    block_q, block_k = min(block_q, L), min(block_k, L)
    if L % block_q or L % block_k:
        raise ValueError(f"flash_attention: L={L} is not a multiple of the blocks ({block_q}, {block_k})")
    return block_q, block_k


def _split_heads(a, heads: int):
    """[B, L, heads * d] -> [B * heads, L, d]."""
    B, L, C = a.shape
    return a.reshape(B, L, heads, C // heads).transpose(1, 2).reshape(B * heads, L, C // heads)


def _merge_heads(a, heads: int):
    BH, L, d = a.shape
    return a.reshape(BH // heads, heads, L, d).transpose(1, 2).reshape(BH // heads, L, heads * d)


def flash_attention_ref(q, k, v, *, scale=None, block_q: int = 256, block_k: int = 512, heads: int = 1):
    """Plain version of `flash_attention`: the same key blocks in the same
    order (query blocks are independent of each other, so all run at once),
    each head on its own."""
    if heads > 1:
        out = flash_attention_ref(*(_split_heads(a, heads) for a in (q, k, v)), scale=scale, block_q=block_q,
                                  block_k=block_k)
        return _merge_heads(out, heads)
    B, L, D = q.shape
    if scale is None:
        scale = D ** -0.5
    _, bk = _blocks(L, block_q, block_k)
    qs = q.to(torch.float32) * scale
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    acc = torch.zeros((B, L, vf.shape[2]), dtype=torch.float32, device=q.device)
    m = torch.full((B, L, 1), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    for i in range(L // bk):
        s = torch.einsum("blc,bmc->blm", qs, kf[:, i * bk:(i + 1) * bk])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("blm,bmc->blc", p, vf[:, i * bk:(i + 1) * bk])
        m = m_new
    return (acc / denom).to(q.dtype)


def flash_attention(q, k, v, *, scale=None, block_q: int = 256, block_k: int = 512, heads: int = 1,
                    plain: bool = False):
    """softmax(q k^T * scale) v with an online softmax; q, k, v: [B, L, D],
    or with `heads` [B, L, heads * d], each head's channels attending alone
    (`scale` defaults to d^-1/2).

    `block_k` is the online softmax's key block (part of the result's last
    bits).  On the card the kernel runs the same recurrence over inner blocks
    of at most 128 keys (64 at D = 256) where `block_k` is larger, which
    moves the last bits again, inside the tolerance held against
    `flash_attention_ref` (2e-5 + 2e-5 |x|).  `block_q` is kept for JAX's
    signature only: it has to divide L, as there, and changes nothing here
    (the kernel sizes its query tiles from D and the batch).  `plain=True`
    runs the plain version on any device.  Inputs that require grad, with
    grad mode on, raise ValueError: K11 has no backward."""
    B, L, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise ValueError(f"flash_attention (K11) has no backward, as JAX's Pallas kernel has none: a map of L={L} "
                         "tokens cannot be differentiated (run it under torch.no_grad(), or attend below L=1024"
                         + (")" if heads == 1 else "; ADM's float forward differentiates through "
                            "models/adm.dense_head_attention)"))
    if D % heads:
        raise ValueError(f"flash_attention: {D} channels are not {heads} whole heads")
    d = D // heads
    if scale is None:
        scale = d ** -0.5
    _, bk = _blocks(L, block_q, block_k)
    if plain or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, block_q=block_q, block_k=block_k, heads=heads)
    if not flash_takes(L, d, bk, heads):
        raise NotImplementedError(
            f"flash_attention on CUDA: D in (128, 256) (a head's in (64, 128, 256)), L and block_k multiples of 64, "
            f"block_k <= 512; got D={d}, heads={heads}, L={L}, block_k={bk}")
    qf, kf, vf = (_build.f32c(a) for a in (q, k, v))
    _build.require_cuda("flash_attention", qf, kf, vf)
    out = torch.empty_like(qf)
    err = _build.kernels().adm_flash_attention(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
                                               B, L, d, heads, bk, float(scale), _build.stream_ptr(q.device))
    _build.check(err, "adm_flash_attention")
    flash_attention.launches += 1
    return out.to(q.dtype)


flash_attention.launches = 0


def spatial_attention(q, k, v, *, scale=None, plain: bool = False):
    """softmax(q k^T * scale) v in float32; q, k, v: [B, L, D].  Long maps on
    the kernel's grid take K11 (q scaled before the dot), the rest the dense
    softmax (the dot scaled after)."""
    B, L, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if takes_flash(L, D):
        return flash_attention(q, k, v, scale=scale, plain=plain)
    w = torch.einsum("blc,bmc->blm", q.float(), k.float()) * scale
    w = torch.softmax(w, dim=-1)
    return torch.einsum("blm,bmc->blc", w, v.float()).to(q.dtype)


def head_attention(q, k, v, heads: int, *, scale=None, plain: bool = False):
    """ADM's multi-head core: softmax(q_h k_h^T * scale) v_h for each head h
    of q, k, v [B, L, heads * d] (channels [h d, (h + 1) d)), float32.  One
    head is `spatial_attention`; more take K11 with `heads` on the card (key
    blocks of 512, or L where shorter) and its plain version on the CPU.
    Several heads raise ValueError where autograd would need gradients, as
    `flash_attention` does: K11 has no backward (ADM's differentiable float
    forward calls `models/adm.dense_head_attention` itself)."""
    if heads == 1:
        return spatial_attention(q, k, v, scale=scale, plain=plain)
    L = q.shape[1]
    return flash_attention(q, k, v, scale=scale, block_q=min(256, L), block_k=min(512, L), heads=heads,
                           plain=plain)
