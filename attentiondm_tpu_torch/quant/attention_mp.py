"""Mixed-precision attention core, stage 3 (port of
`attentiondm_tpu/quant/attention_mp.py`).

The enhanced attention block's core with quantized logits and
probabilities at a timestep-dependent effective bit-width:
- a learned per-timestep importance, sigmoid-mapped to +0..2 bits over a base;
- logits quantized where the effective bits are <= 6 (at >= 4 bits);
- probabilities quantized where they are <= 4 (at >= 3 bits), unsigned, as
  probabilities live in [0, 1];
- a calibrator that runs forwards at probe timesteps and sets scale / zero
  point from the observed logit ranges.

Quantization is the unsigned clamp to [0, 2^b - 1], not the signed conv
quantizer.  Every value stays a tensor on the device: the effective bits and
the timestep are never read back to the host, and both branches of a
quantize-or-not choice are computed and picked with `torch.where`, as JAX's
`jnp.where` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device

FIELDS = ("scale_qk", "zero_qk", "scale_probs", "zero_probs", "timestep_importance", "softmax_scale")


@dataclasses.dataclass
class MPAttentionState:
    """Per-attention-layer mixed-precision state."""

    scale_qk: torch.Tensor  # [] logits quant scale
    zero_qk: torch.Tensor  # []
    scale_probs: torch.Tensor  # []
    zero_probs: torch.Tensor  # []
    timestep_importance: torch.Tensor  # [T] learned (init 0.5)
    softmax_scale: torch.Tensor  # [] learnable softmax temperature

    def to(self, device) -> "MPAttentionState":
        return MPAttentionState(**{f: getattr(self, f).to(device) for f in FIELDS})


def init_mp_attention_state(num_timesteps: int = 1000, device=None) -> MPAttentionState:
    device = default_device() if device is None else device
    f32 = dict(dtype=torch.float32, device=device)
    return MPAttentionState(scale_qk=torch.ones((), **f32), zero_qk=torch.zeros((), **f32),
                            scale_probs=torch.ones((), **f32), zero_probs=torch.zeros((), **f32),
                            timestep_importance=torch.full((num_timesteps,), 0.5, **f32),
                            softmax_scale=torch.ones((), **f32))


def from_jax_mp_states(tree, device=None) -> dict:
    """{name: dict of numpy arrays (the JAX MPAttentionState fields)} ->
    {name: MPAttentionState} on `device` (None: the package's `default_device()`)."""
    device = default_device() if device is None else device
    return {name: MPAttentionState(**{f: torch.tensor(np.asarray(st[f]), dtype=torch.float32, device=device)
                                      for f in FIELDS})
            for name, st in tree.items()}


def effective_bits(state: MPAttentionState, base_bits: int, timestep):
    """base + 2 * sigmoid(importance[t]), a 0-d tensor.  `timestep` is an
    integer (or integer tensor) diffusion timestep, or None for the base."""
    imp = state.timestep_importance
    if timestep is None:
        return torch.full((), float(base_bits), device=imp.device)
    t = torch.as_tensor(timestep, device=imp.device).reshape(1).to(torch.int64)
    return base_bits + 2.0 * torch.sigmoid(imp.index_select(0, t)[0])


def quantize_unsigned(x, scale, zero_point, bits):
    """Unsigned [0, 2^bits - 1] quantize-dequantize; `bits` may be a tensor."""
    qmax = torch.pow(2.0, torch.as_tensor(bits, dtype=x.dtype, device=x.device)) - 1.0
    xq = torch.minimum(torch.clamp(torch.round(x / scale) + zero_point, min=0.0), qmax)
    return (xq - zero_point) * scale


def mp_attention(q, k, v, state: MPAttentionState, *, num_heads: int, base_bits: int, timestep=None,
                 head_split: str = "aligned"):
    """Multi-head attention with conditionally quantized logits / probabilities.

    q: [B, L, C]; k: [B, C, L]; v: [B, L, Cv]; the logits scale by C^-0.5
    over the whole projection.  Returns [B, L, Cv].

    `head_split="aligned"` splits q and k head-major.  `"ref"` keeps the
    reference's split (defect D13): q head-major but k channel-minor, so head
    i attends q channels [i*d, (i+1)*d) against k channels {i, i+h, ...};
    kept for bit parity with the reference."""
    B, L, C = q.shape
    Cv = v.shape[-1]
    h = num_heads
    qh = q.reshape(B, L, h, C // h).transpose(1, 2)  # [B, h, L, d]
    if head_split == "aligned":
        kh = k.reshape(B, h, C // h, L)  # [B, h, d, L], head-major like q
    elif head_split == "ref":
        kh = k.reshape(B, C // h, h, L).transpose(1, 2)  # [B, h, d, L], the reference's d-major split
    else:
        raise ValueError(f"head_split must be 'aligned' or 'ref', got {head_split!r}")
    vh = v.reshape(B, L, h, Cv // h).transpose(1, 2)  # [B, h, L, dv]

    bits = effective_bits(state, base_bits, timestep)
    logits = torch.matmul(qh, kh) * (C ** -0.5)
    # logits quantized at <= 6 effective bits, with a 4-bit floor
    quant_logits = quantize_unsigned(logits, state.scale_qk, state.zero_qk, torch.clamp(torch.floor(bits), min=4.0))
    logits = torch.where(bits <= 6.0, quant_logits, logits)
    probs = torch.softmax(logits * state.softmax_scale, dim=-1)
    # probabilities quantized at <= 4 effective bits, with a 3-bit floor
    quant_probs = quantize_unsigned(probs, state.scale_probs, state.zero_probs,
                                    torch.clamp(torch.floor(bits) - 1.0, min=3.0))
    probs = torch.where(bits <= 4.0, quant_probs, probs)
    out = torch.matmul(probs, vh)  # [B, h, L, dv]
    return out.transpose(1, 2).reshape(B, L, Cv)


def update_quant_params(state: MPAttentionState, qk_min, qk_max, base_bits: int) -> MPAttentionState:
    """Scale / zero point from observed logit ranges (numbers or 0-d
    tensors); the probabilities always span [0, 1]."""
    dev = state.timestep_importance.device
    qk_min, qk_max = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (qk_min, qk_max))
    scale_qk = (qk_max - qk_min) / (2.0 ** base_bits - 1.0)
    return MPAttentionState(
        scale_qk=scale_qk, zero_qk=-qk_min / torch.clamp(scale_qk, min=1e-12),
        scale_probs=torch.full((), 1.0 / (2.0 ** base_bits - 1.0), dtype=torch.float32, device=dev),
        zero_probs=torch.zeros((), dtype=torch.float32, device=dev),
        timestep_importance=state.timestep_importance, softmax_scale=state.softmax_scale)


def make_logit_collector(params, cfg, x):
    """`collect(t) -> {layer name: (min, max)}` for `calibrate_mp_attention`:
    one enhanced UNet forward on `x` at timestep t, each attention block's
    logit range (0-d tensors on the device)."""
    from ..models.unet import unet_apply

    def collect(t):
        stats: dict = {}
        with torch.no_grad():
            unet_apply(params, cfg, x, torch.full((x.shape[0],), float(t), device=x.device),
                       attn_ctx={"collect": stats})
        return stats

    return collect


def calibrate_mp_attention(collect_logits_fn, states: dict, base_bits: int, timesteps=(0, 250, 500, 750, 999)):
    """Stage-3 calibration: forwards at the probe timesteps, each layer's
    logit min / max over them, and each layer's quant params set from that
    range.  `collect_logits_fn(t) -> {layer name: (min, max)}` runs one model
    forward at timestep t (`make_logit_collector`)."""
    mins: dict = {}
    maxs: dict = {}
    for t in timesteps:
        for name, (mn, mx) in collect_logits_fn(t).items():
            mins[name] = torch.minimum(mins[name], mn) if name in mins else torch.as_tensor(mn)
            maxs[name] = torch.maximum(maxs[name], mx) if name in maxs else torch.as_tensor(mx)
    return {name: update_quant_params(st, mins[name], maxs[name], base_bits) if name in mins else st
            for name, st in states.items()}
