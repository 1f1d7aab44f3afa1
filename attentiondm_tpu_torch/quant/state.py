"""Per-layer activation quantization state (port of `attentiondm_tpu/quant/state.py`).

State layout per quantized conv (S sampler steps, C in channels, G groups):
  init_range    [S, 2]      LAPQ-searched base range floor (init -4 / +6)
  act_min/max   [S, C]      group-snapped per-channel calibrated ranges
  group_ranges  [S, G, 2]   per-group (min, max) thresholds
  alpha_logits  [S, G, C]   group-selection logits (init 0.01)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .primitives import fake_quant


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


def from_jax_qstates(tree, device="cpu") -> dict:
    """{name: dict of numpy arrays (the JAX ActQuantState fields)} -> {name: ActQuantState}."""
    fields = [f.name for f in dataclasses.fields(ActQuantState)]
    return {
        name: ActQuantState(**{k: torch.tensor(np.asarray(st[k]), dtype=torch.float32, device=device)
                               for k in fields})
        for name, st in tree.items()
    }


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
