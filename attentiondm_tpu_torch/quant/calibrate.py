"""Stage-1 range calibration (port of the stage-1 part of
`attentiondm_tpu/quant/calibrate.py`).

Per timestep and per channel: collect each conv's input range, search the
LAPQ 9-candidate shrink of the base range floor under an L_0.5 loss, bucket
the ranges group-wise, and propagate the QUANTIZED activation downstream.
Stages 2 and 3 (differentiable group selection, teacher matching, GPTQ /
AdaRound) are later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..models.unet import conv2d, exact_f32, unet_apply
from .groupwise import groupwise_ranges
from .primitives import lp_loss
from .qunet import QuantizedUNet
from .state import ActQuantConfig, ActQuantState, quantize_activation_mixture

LAPQ_CANDIDATES = 9
LAPQ_ACCEPT_SCORE = 0.2


def _calibrate_one_conv(x, st: ActQuantState, cfg: ActQuantConfig, s: int, first: bool):
    """Calibrate one conv's quant state at step `s` from its input `x`.

    Returns (updated fields, quantized activation to propagate downstream)."""
    axes = tuple(range(x.ndim - 1))
    chan_min = x.amin(dim=axes)
    chan_max = x.amax(dim=axes)
    G = cfg.group_num
    alpha = st.alpha_logits[s]

    def build(base_min, base_max):
        # range floor: every channel covers at least [base_min, base_max]
        snap_min, gmin = groupwise_ranges(torch.minimum(chan_min, base_min), G, "min")
        snap_max, gmax = groupwise_ranges(torch.maximum(chan_max, base_max), G, "max")
        return snap_min, snap_max, torch.stack([gmin, gmax], dim=1)

    init_min = st.init_range[s, 0]
    init_max = st.init_range[s, 1]
    if first:
        scores = []
        for aa in range(LAPQ_CANDIDATES):
            f = 1.0 - torch.tensor(float(aa), device=x.device) * 0.1
            _, _, gr = build(init_min * f, init_max * f)
            xq = quantize_activation_mixture(x, gr, alpha, cfg.a_bit)
            scores.append(lp_loss(xq, x, p=0.5, reduction="all"))
        scores = torch.stack(scores)
        best = torch.argmin(scores)
        shrink = 1.0 - best.to(torch.float32) * 0.1
        accept = scores[best] < LAPQ_ACCEPT_SCORE
        init_min = torch.where(accept, init_min * shrink, init_min)
        init_max = torch.where(accept, init_max * shrink, init_max)

    snap_min, snap_max, gr = build(init_min, init_max)
    xq = quantize_activation_mixture(x, gr, alpha, cfg.a_bit)
    updates = dict(init_range=torch.stack([init_min, init_max]), act_min=snap_min,
                   act_max=snap_max, group_ranges=gr, alpha_logits=alpha)
    return updates, xq


def _is_attn_proj(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return (".attn" in name or name.startswith("mid.attn")) and leaf in ("q", "k", "v")


def calibrate_ranges_step(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState],
                          x, t, s: int, first: bool, attn_absmax: dict):
    """One calibration forward at step `s`: update every conv's ranges in
    `qstates` (in place, at index s) and return the FP-graph eps.

    `attn_absmax` collects each attention q/k/v projection's OUTPUT absmax
    at this step, the static scales the int8 q . k^T serving cores quantize
    with (`ops.int8_attention.fused_int8_attention_static`)."""

    def conv_apply(name, xin, p, *, stride=1, padding="SAME"):
        if name not in qstates:
            return conv2d(xin, p, stride=stride, padding=padding)
        upd, xq = _calibrate_one_conv(xin, qstates[name], qunet.policy[name], s, first)
        st = qstates[name]
        for field, v in upd.items():
            getattr(st, field)[s] = v
        out = conv2d(xq, p, stride=stride, padding=padding)
        if _is_attn_proj(name):
            attn_absmax[name] = out.abs().max()
        return out

    return unet_apply(params, qunet.cfg, x, t, conv_apply=conv_apply)


@exact_f32()
def calibrate_ranges(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState],
                     xs: torch.Tensor, seq: Sequence[int], first: bool = True,
                     return_attn_ranges: bool = False, assignment_init: bool = False):
    """Stage-1 calibration over the whole sampler trajectory.

    `xs[i]` [S, N, H, W, C] is the model input at sampling step i (x_t for
    t = reversed(seq)[i]).  Returns new states; the inputs are not changed.

    With `return_attn_ranges` also returns {proj_name: [S] float32}, the
    absmax of each attention q/k/v projection's output per step."""
    if assignment_init:
        raise NotImplementedError(
            "assignment_init is a stage-2 study lever "
            "(ROADMAP Queue 1, 'stage 2/3 calibration and GPTQ/AdaRound')")
    t_rev = np.asarray(list(seq))[::-1].astype(np.float32)
    n = xs.shape[1]
    states = {k: v.clone() for k, v in qstates.items()}
    per_step = []
    for s in range(xs.shape[0]):
        t_vec = torch.full((n,), float(t_rev[s]), dtype=torch.float32, device=xs.device)
        per_step.append({})
        calibrate_ranges_step(qunet, params, states, xs[s], t_vec, s, first, per_step[-1])
    if not return_attn_ranges:
        return states
    return states, {name: torch.stack([d[name] for d in per_step]) for name in per_step[0]}
