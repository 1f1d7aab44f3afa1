"""Quantized UNet assembly (port of `attentiondm_tpu/quant/qunet.py`): the
W4A8 fake-quant model, the reference every int8 serving sample is held to.

The FP UNet graph is unchanged; a `conv_apply` interceptor looks up each
conv's quantization state by name.  Weights are fake-quantized once, per
output channel at w_bit with the MSE range shrink (`prepare_params`).

Bit policy, the reference's attention-aware rules:
  - every conv defaults to (w_bit, a_bit, 8 groups);
  - attention query / value / output projections keep full bitwidth;
  - the attention key projection gets max(4, bitwidth - 2);
  - group counts: q/k -> 8, v -> 4, out -> 8;
the enhanced variant's query_conv / key_conv / value_conv / output_conv take
the rules of q / k / v / proj_out.

The enhanced model's stage-3 mixed-precision core is `unet_apply(...,
conv_apply=make_quant_conv_apply(..., mode="infer"), attn_ctx={"mp_states":
..., "base_bits": ..., "timestep": ...})`, as the JAX runner builds it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.unet import UNetConfig, cast_params, conv2d, iter_conv_layers, lookup, map_tree, unet_apply
from ..ops.quant_conv import quantized_conv2d_int8
from .int8_runtime import _eligible
from .state import (
    ActQuantConfig,
    ActQuantState,
    WeightQuantState,
    init_act_quant_state,
    make_weight_quant_state,
    mixed_ranges,
    quantize_activation,
    quantize_activation_mixture,
    quantize_weight_per_channel,
)


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
            if leaf in ("k", "key_conv"):
                policy[name] = ActQuantConfig(w_bit=max(4, wb - 2), a_bit=max(4, ab - 2), group_num=g(8))
            elif leaf in ("v", "value_conv"):
                policy[name] = ActQuantConfig(w_bit=wb, a_bit=ab, group_num=g(4))
            else:  # q / query_conv, proj_out / output_conv
                policy[name] = ActQuantConfig(w_bit=wb, a_bit=ab, group_num=g(8))
        else:
            policy[name] = ActQuantConfig(w_bit=wb, a_bit=ab, group_num=g(8))
    return policy


def init_qunet_state(cfg: UNetConfig, num_steps: int, policy: Dict[str, ActQuantConfig],
                     device) -> Dict[str, ActQuantState]:
    """Per-timestep activation quant state for every conv."""
    return {name: init_act_quant_state(num_steps, cin, policy[name], device)
            for name, cin, _k in iter_conv_layers(cfg)}


def make_weight_states(params, cfg: UNetConfig,
                       policy: Dict[str, ActQuantConfig] | None = None) -> Dict[str, WeightQuantState]:
    """Per-output-channel weight ranges of every conv; with `policy`,
    MSE-shrink-searched at each layer's w_bit (`make_weight_quant_state`)."""
    return {name: make_weight_quant_state(lookup(params, name)["kernel"], policy[name].w_bit if policy else None)
            for name, _cin, _k in iter_conv_layers(cfg)}


def quantize_params(params, wstates: Dict[str, WeightQuantState], policy: Dict[str, ActQuantConfig],
                    cfg: UNetConfig):
    """A copy of the param tree with every conv kernel fake-quantized per
    output channel (the other leaves shared)."""
    params = map_tree(lambda a: a, params)
    for name, _cin, _k in iter_conv_layers(cfg):
        node = lookup(params, name)
        node["kernel"] = quantize_weight_per_channel(node["kernel"], wstates[name], policy[name].w_bit)
    return params


def make_quant_conv_apply(qstates: Dict[str, ActQuantState], policy: Dict[str, ActQuantConfig], step_idx,
                          mode: str = "infer", collect: dict | None = None):
    """The conv interceptor for `unet_apply`.

    Modes:
      infer   - per-channel fake-quant of the input at the softmax-mixed
                group ranges of step `step_idx`;
      mixture - the calibration path: the G group ranges each quantize the
                input and softmax(alpha_logits) mixes the G outputs, so
                gradients reach the logits;
      int8    - true int8 convs: an eligible conv (1x1 or 3x3, stride 1,
                at least 64 input channels) quantizes its input at the
                step's mixed ranges, folds those scales into its kernel,
                quantizes it per output channel at w_bit (asymmetric) and
                runs `ops/quant_conv.quantized_conv2d_int8` (K13 / K5 on K1);
                the other convs take the infer path (pass the `prepare_params`
                weights, so that they are weight-quantized too);
      collect - no quantization; each conv's per-channel input (min, max)
                into `collect[name]`;
      off     - the plain float conv."""

    def conv_apply(name, x, p, *, stride=1, padding="SAME"):
        if mode == "collect" and collect is not None:
            axes = tuple(range(x.ndim - 1))
            collect[name] = (x.amin(dim=axes), x.amax(dim=axes))
            return conv2d(x, p, stride=stride, padding=padding)
        if mode == "off" or name not in qstates:
            return conv2d(x, p, stride=stride, padding=padding)
        st, bits = qstates[name], policy[name].a_bit
        xf = x.float()
        if mode == "int8" and _eligible(p["kernel"].shape, stride):
            rmin, rmax = mixed_ranges(st, step_idx)
            return quantized_conv2d_int8(xf, p["kernel"].float(), p["bias"].float(), rmin, rmax, bits,
                                         policy[name].w_bit).to(x.dtype)
        if mode in ("infer", "int8"):
            xq = quantize_activation(xf, st, step_idx, bits)
        elif mode == "mixture":
            xq = quantize_activation_mixture(xf, st.group_ranges[step_idx], st.alpha_logits[step_idx], bits)
        else:
            raise ValueError(mode)
        return conv2d(xq.to(p["kernel"].dtype), p, stride=stride, padding=padding)

    return conv_apply


@dataclasses.dataclass
class QuantizedUNet:
    """The static pieces of the quantized model (config and bit policy);
    params and states are passed to `apply` explicitly."""

    cfg: UNetConfig
    policy: Dict[str, ActQuantConfig]

    @classmethod
    def create(cls, cfg: UNetConfig, bitwidth: int, a_bitwidth: int | None = None,
               group_num: int = 0) -> "QuantizedUNet":
        return cls(cfg=cfg, policy=make_bit_policy(cfg, bitwidth, a_bitwidth, group_num))

    def init_state(self, num_steps: int, device) -> Dict[str, ActQuantState]:
        return init_qunet_state(self.cfg, num_steps, self.policy, device)

    def prepare_params(self, params, compute_dtype=None):
        """Quantize the weights once: (quantized params, weight states).
        The quantization runs in float32; `compute_dtype` (e.g. bfloat16)
        then casts the quantized params for a run at that dtype."""
        ws = make_weight_states(params, self.cfg, self.policy)
        qp = quantize_params(params, ws, self.policy, self.cfg)
        return (qp if compute_dtype is None else cast_params(qp, compute_dtype)), ws

    def apply(self, qparams, qstates, x, t, step_idx, mode="infer", compute_dtype=None):
        """eps of the fake-quant model; with `compute_dtype` the activations
        run at that dtype (`unet_apply`), each conv's range math in float32
        and its conv at the kernel's dtype."""
        ca = make_quant_conv_apply(qstates, self.policy, step_idx, mode=mode)
        return unet_apply(qparams, self.cfg, x, t, conv_apply=ca, compute_dtype=compute_dtype)

    def model_fn(self, qparams, qstates, mode="infer", compute_dtype=None):
        """Sampler-compatible `(x, t, step_idx) -> eps` closure."""

        def fn(x, t, step_idx):
            return self.apply(qparams, qstates, x, t, step_idx, mode=mode, compute_dtype=compute_dtype)

        return fn
