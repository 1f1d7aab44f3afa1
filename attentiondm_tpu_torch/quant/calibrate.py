"""Range calibration and the fold's refinement (port of stage 1,
`serving_surrogate_apply` and `refine_weight_extras` of
`attentiondm_tpu/quant/calibrate.py`).

Stage 1, per timestep and per channel: collect each conv's input range,
search the LAPQ 9-candidate shrink of the base range floor under an L_0.5
loss, bucket the ranges group-wise, and propagate the QUANTIZED activation
downstream.  The serving surrogate is a differentiable forward with the
serving fold's numerics; `refine_weight_extras` trains the fold's free
per-channel multiplier and bias shift through it.  Stage 2 (differentiable
group selection, teacher matching) is a later slice (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from ..models.unet import conv2d, exact_f32, lookup, unet_apply
from ..ops.quant_conv import weight_grid
from .groupwise import groupwise_ranges
from .primitives import clip, div, lp_loss, ste_floor, ste_round
from .qunet import QuantizedUNet
from .state import ActQuantConfig, ActQuantState, mixed_ranges, quantize_activation_mixture

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
            "assignment_init is a stage-2 study lever; it comes with ROADMAP Queue 1 item 4")
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


# ---------------------------------------------------------------------------
# the serving surrogate: a differentiable forward with the serving fold's numerics
# ---------------------------------------------------------------------------


@exact_f32()
def serving_surrogate_apply(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState], weight_extras,
                            x, t, s: int, *, symmetric: bool = True, rank1: bool = False):
    """Differentiable forward that follows `quant.int8_serving`'s numerics.

    An eligible conv with extras runs conv(x_hat, W_hat_s): x_hat the
    fake-quant of its input at step s's mixed ranges, W_hat_s = g_hat_s *
    act_scale the decoded fold of step s (`fold_weights_int8`'s grid with the
    pinned shrink, the round offsets, `out_mult`, `bias_delta` and the bias
    correction).  The other convs fake-quantize their input and keep their
    float weights.  Every rounding passes its gradient straight through, so
    gradients reach `out_mult` / `bias_delta` through the fold and the
    activation grids.  `params` are the float params (the fold reads them).

    `rank1` follows the step-shared fold (quant/rank1.py): eligible convs
    quantize at the rank-1 scales and re-centred zero points, and the weight
    grid sits on the step-independent factor u."""
    ca = surrogate_conv_apply(qunet, qstates, weight_extras, s, symmetric=symmetric, rank1=rank1)
    return unet_apply(params, qunet.cfg, x, t, conv_apply=ca)


def surrogate_conv_apply(qunet: QuantizedUNet, qstates: Dict[str, ActQuantState], weight_extras, s: int, *,
                         symmetric: bool = True, rank1: bool = False):
    """The conv interceptor of `serving_surrogate_apply` at step s."""
    from .int8_runtime import _eligible
    from .rank1 import rank1_factors, rank1_scale_zp

    def conv_apply(name, xin, p, *, stride=1, padding="SAME"):
        if name not in qstates:
            return conv2d(xin, p, stride=stride, padding=padding)
        st, pol = qstates[name], qunet.policy[name]
        xf, kernel = xin.to(torch.float32), p["kernel"].to(torch.float32)
        na = 2 ** (pol.a_bit - 1)
        eligible = stride == 1 and _eligible(kernel.shape)
        u = mfac = None
        if rank1 and eligible:
            u, mfac = rank1_factors(st, pol.a_bit)
            scale_all, zp_all = rank1_scale_zp(st, pol.a_bit, u, mfac)
            scale, zp = scale_all[s], zp_all[s]
        else:
            rmin, rmax = mixed_ranges(st, s)
            scale = div(2 ** pol.a_bit - 1, rmax - rmin)
            zp = torch.round(scale * rmin) + na
        x_hat = (clip(ste_round(scale * xf - zp), -na, na - 1) + zp) / scale

        ex = weight_extras.get(name) if weight_extras else None
        if not eligible or ex is None or ex.shrink is None:
            return conv2d(x_hat, p, stride=stride, padding=padding)
        kh, kw, ci, co = kernel.shape
        g = kernel / (u if u is not None else scale).reshape(1, 1, ci, 1)
        nw = 2 ** (pol.w_bit - 1)
        ws, wzp = weight_grid(g, pol.w_bit, symmetric, ex.shrink)
        base = ws * g - wzp
        if ex.round_offset is not None:
            gq = clip(ste_floor(base) + ex.round_offset.to(base.dtype), -nw, nw - 1)
        else:
            gq = clip(ste_round(base), -nw, nw - 1)
        g_hat = (gq + wzp) / ws
        if mfac is not None:
            g_hat = g_hat / mfac[s]  # the shared grid decodes at step s
        if ex.out_mult is not None:
            g_hat = g_hat * (ex.out_mult if ex.out_mult.ndim == 1 else ex.out_mult[s])
        bias = p["bias"]
        if ex.bias_delta is not None:
            bias = bias + (ex.bias_delta if ex.bias_delta.ndim == 1 else ex.bias_delta[s])
        out = conv2d(x_hat, {"kernel": g_hat * scale.reshape(1, 1, ci, 1), "bias": bias}, stride=stride,
                     padding=padding)
        if ex.mu is not None:
            g_step = kernel / scale.reshape(1, 1, ci, 1)
            out = out + ex.mu @ (g_step.reshape(kh * kw * ci, co) - g_hat.reshape(kh * kw * ci, co))
        return out

    return conv_apply


# ---------------------------------------------------------------------------
# Stage 3: trajectory-distilled fold refinement
# ---------------------------------------------------------------------------


def refine_weight_extras(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState], extras, xs_in, eps_ref,
                         seq: Sequence[int], *, lr: float | None = None, epochs: int = 8, train_mult: bool = True,
                         train_bias: bool = True, symmetric: bool = True, rank1: bool = False, per_step: bool = False,
                         inner: int = 24, chunk: int | None = None):
    """Train the fold's free per-output-channel parameters, the decoded-weight
    multiplier `out_mult` and the bias shift `bias_delta` (WeightExtras), to
    lower the per-step relative eps error against the FP teacher on its own
    trajectory (`xs_in`, `eps_ref` [S, N, H, W, C]), through
    `serving_surrogate_apply`.  Both land in the fold's `inv_ws` / `zcbias`,
    at no runtime cost.  `optax.adam(lr)` becomes `torch.optim.Adam(lr=lr)`.

    - ``per_step=False``: one [co] correction per layer shared by the steps,
      trained `epochs` passes over the trajectory (one Adam update per step
      visit), with the best epoch kept (the init counts as epoch 0).
    - ``per_step=True``: an independent [S, co] correction per layer.  The
      steps are independent given the teacher trajectory, so each `chunk` of
      steps is solved by its own `inner`-iteration Adam run on the mean of
      its steps' losses (JAX maps the chunk's steps with `vmap`; here they
      are a loop), keeping the chunk's best iterate.

    Either way the result is never worse than the init on the surrogate's
    objective.  Returns (extras', losses): the per-epoch mean losses (entry 0
    the init) in the shared mode; [n_chunks, inner+1] per-chunk loss traces
    (column 0 the init) per step."""
    if lr is None:
        lr = 5e-3 if per_step else 2e-3
    t_rev = np.asarray(list(seq))[::-1].astype(np.float32)
    S, n = xs_in.shape[0], xs_in.shape[1]
    sel = [nm for nm, ex in extras.items() if ex.shrink is not None]
    if not sel or not (train_mult or train_bias):
        return extras, []

    def init_field(val, co, log: bool):
        if val is None:
            base = torch.zeros((co,), dtype=torch.float32, device=xs_in.device)
        else:
            base = torch.log(val.to(torch.float32)) if log else val.to(torch.float32)
        if per_step and base.ndim == 1:
            base = base.expand(S, co)
        return base.clone()

    theta0 = {}
    if train_mult:
        theta0["logm"] = {nm: init_field(extras[nm].out_mult, lookup(params, nm)["kernel"].shape[3], True)
                          for nm in sel}
    if train_bias:
        theta0["bd"] = {nm: init_field(extras[nm].bias_delta, lookup(params, nm)["kernel"].shape[3], False)
                        for nm in sel}

    def apply_theta(th, pick=lambda v: v):
        """The extras with theta's fields (each read through `pick`)."""
        out = dict(extras)
        for nm in sel:
            ex = extras[nm]
            m = torch.exp(pick(th["logm"][nm])) if "logm" in th else ex.out_mult
            bd = pick(th["bd"][nm]) if "bd" in th else ex.bias_delta
            out[nm] = dataclasses.replace(ex, out_mult=m, bias_delta=bd)
        return out

    def leaves(th):
        return [v for fields in th.values() for v in fields.values()]

    def detached(th):
        return {k: {nm: v.detach().clone() for nm, v in fields.items()} for k, fields in th.items()}

    def step_loss(ex2, s: int):
        et = serving_surrogate_apply(qunet, params, qstates, ex2, xs_in[s],
                                     torch.full((n,), float(t_rev[s]), device=xs_in.device), s,
                                     symmetric=symmetric, rank1=rank1)
        e_s = eps_ref[s]
        return torch.mean(torch.square(et - e_s)) / torch.mean(torch.square(e_s))

    if per_step:
        if chunk is None:
            chunk = next(m for m in (8, 5, 4, 2, 1) if S % m == 0)
        if S % chunk:
            raise ValueError(f"per_step refinement: chunk={chunk} does not divide the {S} steps")
        theta = detached(theta0)
        traces = np.zeros((S // chunk, inner + 1), np.float32)
        for c in range(S // chunk):
            rows = slice(c * chunk, (c + 1) * chunk)
            th = {k: {nm: v[rows].clone().requires_grad_(True) for nm, v in fields.items()}
                  for k, fields in theta.items()}

            def chunk_loss():
                return torch.stack([step_loss(apply_theta(th, lambda v: v[i]), c * chunk + i)
                                    for i in range(chunk)]).mean()

            opt = torch.optim.Adam(leaves(th), lr=lr)
            best_l, best_th = float("inf"), detached(th)
            for i in range(inner):
                loss = chunk_loss()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                traces[c, i] = lv = loss.item()
                if lv < best_l:  # the iterate whose loss this is, before the update
                    best_l, best_th = lv, detached(th)
                opt.step()
            with torch.no_grad():
                traces[c, inner] = lf = chunk_loss().item()
            if lf < best_l:
                best_th = detached(th)
            for k, fields in best_th.items():
                for nm, v in fields.items():
                    theta[k][nm][rows] = v
        return apply_theta(theta), traces

    def eval_epoch(th):
        with torch.no_grad():
            return torch.stack([step_loss(apply_theta(th), s) for s in range(S)]).mean().item()

    best_theta = theta0
    best_loss = eval_epoch(theta0)
    losses = [best_loss]
    theta = {k: {nm: v.clone().requires_grad_(True) for nm, v in fields.items()} for k, fields in theta0.items()}
    opt = torch.optim.Adam(leaves(theta), lr=lr)
    for _ep in range(epochs):
        for s in range(S):
            loss = step_loss(apply_theta(theta), s)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        l_ep = eval_epoch(theta)
        losses.append(l_ep)
        if l_ep < best_loss:
            best_loss, best_theta = l_ep, detached(theta)
    return apply_theta(best_theta), losses
