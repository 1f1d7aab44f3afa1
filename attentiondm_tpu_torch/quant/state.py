"""Per-layer quantization state (port of `attentiondm_tpu/quant/state.py`).

Activation state per quantized conv (S sampler steps, C in channels, G groups):
  init_range    [S, 2]      LAPQ-searched base range floor (init -4 / +6)
  act_min/max   [S, C]      group-snapped per-channel calibrated ranges
  group_ranges  [S, G, 2]   per-group (min, max) thresholds
  alpha_logits  [S, G, C]   group-selection logits (init 0.01)

Weights: per-output-channel asymmetric ranges (`WeightQuantState`), each
optionally shrunk by the factor that minimizes the channel's reconstruction
error at w_bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..ops.quant_conv import WEIGHT_MSE_SHRINKS
from .primitives import div, fake_quant


@dataclasses.dataclass(frozen=True)
class ActQuantConfig:
    """Static quantization hyperparameters for one layer."""

    w_bit: int = 8
    a_bit: int = 8
    group_num: int = 8
    init_min: float = -4.0
    init_max: float = 6.0


@dataclasses.dataclass
class ActQuantState:
    init_range: torch.Tensor  # [S, 2]
    act_min: torch.Tensor  # [S, C]
    act_max: torch.Tensor  # [S, C]
    group_ranges: torch.Tensor  # [S, G, 2]
    alpha_logits: torch.Tensor  # [S, G, C]

    def clone(self) -> "ActQuantState":
        return ActQuantState(**{f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)})

    def to(self, device) -> "ActQuantState":
        return ActQuantState(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


def init_act_quant_state(num_steps: int, in_channels: int, cfg: ActQuantConfig, device) -> ActQuantState:
    S, C, G = num_steps, in_channels, cfg.group_num
    f32 = dict(dtype=torch.float32, device=device)
    return ActQuantState(
        init_range=torch.tensor([[cfg.init_min, cfg.init_max]], **f32).repeat(S, 1),
        act_min=torch.zeros((S, C), **f32),
        act_max=torch.zeros((S, C), **f32),
        group_ranges=torch.zeros((S, G, 2), **f32),
        alpha_logits=torch.full((S, G, C), 0.01, **f32),
    )


@dataclasses.dataclass
class WeightQuantState:
    w_min: torch.Tensor  # [C_out]
    w_max: torch.Tensor  # [C_out]


def make_weight_quant_state(w, w_bit: int | None = None) -> WeightQuantState:
    """Per-output-channel ranges of an HWIO kernel (reduced over every axis
    but the last), clamped so that zero is representable and min < max.

    With `w_bit`, each channel's range is shrunk by the factor of
    WEIGHT_MSE_SHRINKS (first minimum wins) that minimizes its weight
    reconstruction error at `w_bit`."""
    axes = tuple(range(w.ndim - 1))
    w_min = torch.clamp(w.amin(dim=axes), max=0.0)
    w_max = torch.clamp(w.amax(dim=axes), min=1e-8)
    if w_bit is None:
        return WeightQuantState(w_min=w_min, w_max=w_max)
    wn = w.to(torch.float32).reshape(-1, w.shape[-1])  # [M, O]
    mn, mx = w_min.to(torch.float32), w_max.to(torch.float32)
    half = 2.0 ** (w_bit - 1)
    best_err, best_k = None, torch.ones_like(mn)
    for k in WEIGHT_MSE_SHRINKS:
        scale = div(2.0 ** w_bit - 1.0, (mx - mn) * k)
        zp = torch.round(scale * mn * k) + half
        q = torch.clamp(torch.round(wn * scale - zp), -half, half - 1)
        err = torch.square((q + zp) / scale - wn).sum(dim=0)  # [O]
        if best_err is None:
            best_err = err
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_k = torch.where(better, torch.full_like(best_k, k), best_k)
    best = best_k.to(w.dtype)
    return WeightQuantState(w_min=w_min * best, w_max=w_max * best)


def quantize_weight_per_channel(w, wq: WeightQuantState, w_bit: int):
    """Fake-quantize HWIO weights per output channel at w_bit."""
    return fake_quant(w, w_bit, wq.w_min, wq.w_max, ste=False)


def from_jax_qstates(tree, device=None) -> dict:
    """{name: dict of numpy arrays (the JAX ActQuantState fields)} -> {name: ActQuantState}
    on `device` (None: the package's `default_device()`)."""
    device = default_device() if device is None else device
    fields = [f.name for f in dataclasses.fields(ActQuantState)]
    return {
        name: ActQuantState(**{k: torch.tensor(np.asarray(st[k]), dtype=torch.float32, device=device)
                               for k in fields})
        for name, st in tree.items()
    }


def from_jax_attn_ranges(tree, device=None) -> dict:
    """{proj_name: numpy [S]} (JAX's `attn_ranges`) -> {proj_name: float32 tensor [S]} on `device`
    (None: the package's `default_device()`)."""
    device = default_device() if device is None else device
    return {name: torch.tensor(np.asarray(a), dtype=torch.float32, device=device) for name, a in tree.items()}


def mixed_ranges(state: ActQuantState, idx):
    """Per-channel (min, max) from the softmax group mixture at step `idx`."""
    sw = torch.softmax(state.alpha_logits[idx], dim=0)  # [G, C]
    gr = state.group_ranges[idx]  # [G, 2]
    return (gr[:, 0:1] * sw).sum(dim=0), (gr[:, 1:2] * sw).sum(dim=0)


def quantize_activation(x, state: ActQuantState, idx, a_bit: int):
    """Fake-quantize channel-last activations at step `idx` (inference path)."""
    rmin, rmax = mixed_ranges(state, idx)
    return fake_quant(x, a_bit, rmin, rmax)


def quantize_activation_mixture(x, group_ranges, alpha_logits, a_bit: int):
    """Calibration path: each group range quantizes the whole tensor, and the
    per-channel softmax over `alpha_logits` [G, C] mixes the G outputs."""
    sw = torch.softmax(alpha_logits, dim=0)  # [G, C]
    G = group_ranges.shape[0]
    bshape = (G,) + (1,) * x.ndim
    xg = fake_quant(x[None], a_bit, group_ranges[:, 0].reshape(bshape), group_ranges[:, 1].reshape(bshape))
    sw_b = sw.reshape((G,) + (1,) * (x.ndim - 1) + sw.shape[1:])
    return (xg * sw_b).sum(dim=0)
