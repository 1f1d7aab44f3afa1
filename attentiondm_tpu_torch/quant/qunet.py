"""Quantized UNet assembly (port of `attentiondm_tpu/quant/qunet.py`).

Bit policy, the reference's attention-aware rules:
  - every conv defaults to (w_bit, a_bit, 8 groups);
  - attention query / value / output projections keep full bitwidth;
  - the attention key projection gets max(4, bitwidth - 2);
  - group counts: q/k -> 8, v -> 4, out -> 8.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.unet import UNetConfig, iter_conv_layers
from .state import ActQuantConfig, ActQuantState, init_act_quant_state


def make_bit_policy(cfg: UNetConfig, bitwidth: int, a_bitwidth: int | None = None,
                    group_num: int = 0) -> Dict[str, ActQuantConfig]:
    """Static per-layer quantization configs, keyed by conv name."""
    wb = bitwidth
    ab = bitwidth if a_bitwidth is None else a_bitwidth

    def g(default):
        return group_num if group_num > 0 else default

    policy = {}
    for name, _cin, _k in iter_conv_layers(cfg):
        leaf = name.rsplit(".", 1)[-1]
        if ".attn" in name or name.startswith("mid.attn"):
            if leaf == "k":
                policy[name] = ActQuantConfig(w_bit=max(4, wb - 2), a_bit=max(4, ab - 2), group_num=g(8))
            elif leaf == "v":
                policy[name] = ActQuantConfig(w_bit=wb, a_bit=ab, group_num=g(4))
            else:
                policy[name] = ActQuantConfig(w_bit=wb, a_bit=ab, group_num=g(8))
        else:
            policy[name] = ActQuantConfig(w_bit=wb, a_bit=ab, group_num=g(8))
    return policy


def init_qunet_state(cfg: UNetConfig, num_steps: int, policy: Dict[str, ActQuantConfig],
                     device) -> Dict[str, ActQuantState]:
    """Per-timestep activation quant state for every conv."""
    return {name: init_act_quant_state(num_steps, cin, policy[name], device)
            for name, cin, _k in iter_conv_layers(cfg)}


@dataclasses.dataclass
class QuantizedUNet:
    """The static pieces of the quantized model: config and bit policy."""

    cfg: UNetConfig
    policy: Dict[str, ActQuantConfig]

    @classmethod
    def create(cls, cfg: UNetConfig, bitwidth: int, a_bitwidth: int | None = None,
               group_num: int = 0) -> "QuantizedUNet":
        return cls(cfg=cfg, policy=make_bit_policy(cfg, bitwidth, a_bitwidth, group_num))

    def init_state(self, num_steps: int, device) -> Dict[str, ActQuantState]:
        return init_qunet_state(self.cfg, num_steps, self.policy, device)
