"""Calibration (port of `attentiondm_tpu/quant/calibrate.py`).

- Stage 1, per timestep and per channel: collect each conv's input range,
  search the LAPQ 9-candidate shrink of the base range floor under an L_0.5
  loss, bucket the ranges group-wise, and propagate the QUANTIZED activation
  downstream (`calibrate_ranges`, optionally seeding each channel's
  group-selection logits on its own bucket, `assignment_init`).
- Stage 2: the differentiable group selection along the sampler trajectory
  with an entropy regularizer (`calibrate_differentiable`), or its
  teacher-matched variant, which trains the logits and a per-step log range
  scale against the FP teacher's eps on its own trajectory
  (`calibrate_teacher_matched`), through the fake-quant model or the serving
  surrogate.
- The serving surrogate, a differentiable forward with the serving fold's
  numerics, and `refine_weight_extras`, which trains the fold's free
  per-channel multiplier and bias shift through it.
- The calibration set: `select_calibration_images` in the four t-modes,
  with the alpha-entropy-driven "diff" selection (`alpha_uncertainty`).

The optimizers are torch's, each over the whole [S, ...] tensors for the
whole run, as JAX keeps one optax state over them: a step's update also
moves the slices other steps updated earlier (Adam's moments) and, in
stage 2's AdamW, decays every slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.sampling import _seq_alphas, ddim_step
from ..models.unet import conv2d, exact_f32, lookup, unet_apply
from ..ops.quant_conv import weight_grid
from .groupwise import groupwise_ranges
from .primitives import clip, div, lp_loss, ste_floor, ste_round
from .qunet import QuantizedUNet
from .state import ActQuantConfig, ActQuantState, mixed_ranges, quantize_activation_mixture

LAPQ_CANDIDATES = 9
LAPQ_ACCEPT_SCORE = 0.2
# Assignment-init logit magnitude: the softmax weight on a channel's own bucket is
# 1/(1+(G-1)e^-K) = 0.9992 at G=8, K=9, about one-hot while staying differentiable for stage 2.
ASSIGN_LOGIT = 9.0


def _assignment_logits(gr, snap_min, snap_max, scale: float = ASSIGN_LOGIT):
    """[G, C] logits that put each channel on its own bucket (the nearest
    group range in L1 to its snapped range; the first on a tie), `scale`
    where it is and 0 elsewhere.  A study lever: the default stage-1 init
    keeps the reference's uniform logits."""
    d = (gr[:, 0:1] - snap_min[None, :]).abs() + (gr[:, 1:2] - snap_max[None, :]).abs()
    own = torch.argmin(d, dim=0)  # [C]
    return F.one_hot(own, gr.shape[0]).T.to(torch.float32) * scale


def _calibrate_one_conv(x, st: ActQuantState, cfg: ActQuantConfig, s: int, first: bool, assignment: bool = False):
    """Calibrate one conv's quant state at step `s` from its input `x`;
    `assignment` seeds the logits with each channel's own bucket.

    Returns (updated fields, quantized activation to propagate downstream)."""
    axes = tuple(range(x.ndim - 1))
    chan_min = x.amin(dim=axes)
    chan_max = x.amax(dim=axes)
    G = cfg.group_num

    def build(base_min, base_max):
        # range floor: every channel covers at least [base_min, base_max]
        snap_min, gmin = groupwise_ranges(torch.minimum(chan_min, base_min), G, "min")
        snap_max, gmax = groupwise_ranges(torch.maximum(chan_max, base_max), G, "max")
        gr = torch.stack([gmin, gmax], dim=1)
        alpha = _assignment_logits(gr, snap_min, snap_max) if assignment else st.alpha_logits[s]
        return snap_min, snap_max, gr, alpha

    init_min = st.init_range[s, 0]
    init_max = st.init_range[s, 1]
    if first:
        scores = []
        for aa in range(LAPQ_CANDIDATES):
            f = 1.0 - torch.tensor(float(aa), device=x.device) * 0.1
            _, _, gr, alpha = build(init_min * f, init_max * f)
            xq = quantize_activation_mixture(x, gr, alpha, cfg.a_bit)
            scores.append(lp_loss(xq, x, p=0.5, reduction="all"))
        scores = torch.stack(scores)
        best = torch.argmin(scores)
        shrink = 1.0 - best.to(torch.float32) * 0.1
        accept = scores[best] < LAPQ_ACCEPT_SCORE
        init_min = torch.where(accept, init_min * shrink, init_min)
        init_max = torch.where(accept, init_max * shrink, init_max)

    snap_min, snap_max, gr, alpha = build(init_min, init_max)
    xq = quantize_activation_mixture(x, gr, alpha, cfg.a_bit)
    updates = dict(init_range=torch.stack([init_min, init_max]), act_min=snap_min,
                   act_max=snap_max, group_ranges=gr, alpha_logits=alpha)
    return updates, xq


def _is_attn_proj(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return (".attn" in name or name.startswith("mid.attn")) and leaf in ("q", "k", "v")


def calibrate_ranges_step(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState],
                          x, t, s: int, first: bool, attn_absmax: dict, assignment: bool = False):
    """One calibration forward at step `s`: update every conv's ranges in
    `qstates` (in place, at index s) and return the FP-graph eps.

    `attn_absmax` collects each attention q/k/v projection's OUTPUT absmax
    at this step, the static scales the int8 q . k^T serving cores quantize
    with (`ops.int8_attention.fused_int8_attention_static`)."""

    def conv_apply(name, xin, p, *, stride=1, padding="SAME"):
        if name not in qstates:
            return conv2d(xin, p, stride=stride, padding=padding)
        upd, xq = _calibrate_one_conv(xin, qstates[name], qunet.policy[name], s, first, assignment)
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
    absmax of each attention q/k/v projection's output per step.

    `assignment_init` seeds `alpha_logits` with each channel's own bucket
    (`_assignment_logits`); the default keeps the reference's uniform init,
    under which the inference mixture is the mean of the group thresholds
    until stage 2 learns otherwise."""
    t_rev = np.asarray(list(seq))[::-1].astype(np.float32)
    n = xs.shape[1]
    states = {k: v.clone() for k, v in qstates.items()}
    per_step = []
    for s in range(xs.shape[0]):
        t_vec = torch.full((n,), float(t_rev[s]), dtype=torch.float32, device=xs.device)
        per_step.append({})
        calibrate_ranges_step(qunet, params, states, xs[s], t_vec, s, first, per_step[-1], assignment_init)
    if not return_attn_ranges:
        return states
    return states, {name: torch.stack([d[name] for d in per_step]) for name in per_step[0]}


# ---------------------------------------------------------------------------
# Stage 2: differentiable group selection along the trajectory
# ---------------------------------------------------------------------------


def _is_attn(name: str) -> bool:
    return ".attn" in name or name.startswith("mid.attn")


def _with_fields(qstates: Dict[str, ActQuantState], alphas=None, group_ranges=None) -> Dict[str, ActQuantState]:
    """A copy of the state dict whose named layers take the given
    `alpha_logits` / `group_ranges` ({name: tensor}); the other fields shared."""
    out = dict(qstates)
    for name in set(alphas or {}) | set(group_ranges or {}):
        out[name] = dataclasses.replace(out[name], **{
            k: v[name] for k, v in (("alpha_logits", alphas), ("group_ranges", group_ranges)) if v and name in v})
    return out


def _alpha_entropy(alpha_logits_s, g: int, c: int):
    """The reference's (pseudo-)entropy regularizer of one step's [G, C]
    logits: softmax over the groups, -sum(p log p) over the channels, the
    mean over the groups, / (G * C)."""
    p = torch.softmax(alpha_logits_s, dim=0)
    return -(p * torch.log(p + 1e-12)).sum(dim=-1).mean() / (g * c)


def _draw(shape, generator, device):
    """Standard normals from `generator` (on its own device), moved to `device`."""
    if generator is None:
        raise ValueError("pass a torch.Generator (generator=) or the draws themselves")
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def _stage2_loss(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState], alphas, xt, e, a, t: float, s: int,
                 diff_loss_weight: float):
    """Stage 2's loss at step s, and the eps of its forward: x_t noised
    with `e` at alpha_bar `a` as if it were x0, the mixture-mode model at
    step s with `alphas` ({name: [S, G, C]}) in place of those layers'
    logits, ((e - et)^2) summed over H, W, C and averaged over the images,
    plus `diff_loss_weight` times the sum of the `alphas`' entropies at s."""
    x_noised = xt * torch.sqrt(a) + e * torch.sqrt(1.0 - a)
    t_vec = torch.full((xt.shape[0],), t, device=xt.device)
    et = qunet.apply(params, _with_fields(qstates, alphas), x_noised, t_vec, s, mode="mixture")
    ent = sum(_alpha_entropy(v[s], v.shape[1], v.shape[2]) for v in alphas.values())
    return torch.square(e - et).sum(dim=(1, 2, 3)).mean() + diff_loss_weight * ent, et


def calibrate_differentiable(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState], x0, seq: Sequence[int],
                             betas, *, generator: torch.Generator | None = None, noise=None, eta: float = 0.0,
                             lr: float = 0.05, weight_decay: float = 0.05, diff_loss_weight: float = 1.0,
                             attention_focus: bool = False, epochs: int = 1):
    """Stage 2: optimize `alpha_logits` with AdamW along the DDIM trajectory
    of the calibration images `x0` (NHWC).

    At each step the loss is `_stage2_loss`'s (the eps-MSE of the
    mixture-mode model on the current x_t noised afresh, plus the entropy
    term), one optimizer step a sampler step, and x advances by the DDIM
    update with the loss forward's eps.  `attention_focus` trains the
    attention projections' logits only.  `epochs` repeats the pass (fresh
    noise, the same x0, the optimizer state carried over).

    One `torch.optim.AdamW(lr, weight_decay)` over the selected layers' whole
    [S, G, C] logits: optax's `adamw` and torch's both decouple the decay
    from the gradient and scale it by `lr`, and both decay every slice at
    every step.  The noise is `noise` [epochs, S, N, H, W, C] (e.g. JAX's
    `fold_in(key, ep * S + i)` draws) or drawn from `generator`.  Returns
    (states', losses [epochs * S] floats)."""
    sel = [n for n in qstates if not attention_focus or _is_attn(n)]
    _, _, at_all, at_next_all = _seq_alphas(betas, seq)
    t_rev = [int(t) for t in reversed(list(seq))]
    abar = torch.cumprod(1.0 - betas, dim=0)
    alphas = {k: qstates[k].alpha_logits.detach().clone().requires_grad_(True) for k in sel}
    opt = torch.optim.AdamW(list(alphas.values()), lr=lr, weight_decay=weight_decay)
    losses = []
    with exact_f32():
        for ep in range(epochs):
            xt = x0
            for s, t in enumerate(t_rev):
                e = noise[ep, s].to(xt.device) if noise is not None else _draw(xt.shape, generator, xt.device)
                loss, et = _stage2_loss(qunet, params, qstates, alphas, xt, e, abar[t], float(t), s, diff_loss_weight)
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(loss.detach())
                xt, _ = ddim_step(xt, et.detach(), at_all[s], at_next_all[s], eta, torch.zeros_like(xt))
    out = _with_fields(qstates, {k: v.detach() for k, v in alphas.items()})
    return out, torch.stack(losses).tolist() if losses else []


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
# Stage 2, teacher-matched
# ---------------------------------------------------------------------------


def _apply_theta(qstates: Dict[str, ActQuantState], theta) -> Dict[str, ActQuantState]:
    """The states with the teacher-matched parameters: theta["alpha"]
    ({name: [S, G, C]}) as the logits, group_ranges * exp(theta["rho"][name])
    ({name: [S]}) as the ranges."""
    gr = None
    if "rho" in theta:
        gr = {k: qstates[k].group_ranges * torch.exp(r)[:, None, None] for k, r in theta["rho"].items()}
    return _with_fields(qstates, theta.get("alpha"), gr)


def _teacher_matched_loss(qunet: QuantizedUNet, forward_params, qstates: Dict[str, ActQuantState], theta, x_s, e_s,
                          t: float, s: int, *, serving_extras=None, symmetric: bool = True, rank1: bool = False):
    """The teacher-matched objective at step s: mean((et - e_s)^2) /
    mean(e_s^2), et the fake-quant model's (mode "infer") eps or, with
    `serving_extras`, the serving surrogate's, under `_apply_theta(qstates,
    theta)`."""
    qs = _apply_theta(qstates, theta)
    t_vec = torch.full((x_s.shape[0],), t, device=x_s.device)
    if serving_extras is not None:
        et = serving_surrogate_apply(qunet, forward_params, qs, serving_extras, x_s, t_vec, s, symmetric=symmetric,
                                     rank1=rank1)
    else:
        et = qunet.apply(forward_params, qs, x_s, t_vec, s, mode="infer")
    return torch.mean(torch.square(et - e_s)) / torch.mean(torch.square(e_s))


def calibrate_teacher_matched(qunet: QuantizedUNet, forward_params, qstates: Dict[str, ActQuantState], xs_in, eps_ref,
                              seq: Sequence[int], *, lr: float = 0.01, epochs: int = 4, attention_focus: bool = False,
                              train_alpha: bool = True, train_range_scale: bool = True, serving_extras=None,
                              symmetric: bool = True, rank1: bool = False):
    """Distillation-objective stage 2: train the activation quantization
    against the FP teacher's eps on its own trajectory (`xs_in`, `eps_ref`
    [S, N, H, W, C]), `_teacher_matched_loss` at each step, one Adam update a
    step visit, `epochs` passes.  The parameters are `alpha_logits`
    (`train_alpha`) and a per-layer per-step log range scale rho
    (`train_range_scale`, init 0), of the attention projections alone with
    `attention_focus`.

    The loss forward is the fake-quant model on `forward_params`, the
    weight-quantized params (`prepare_params`), or, with `serving_extras`,
    `serving_surrogate_apply` on the float params (the serving fold's
    semantics with the extras' offsets and pinned shrinks; `rank1` its
    step-shared form; `symmetric=False` the asymmetric weight grid of the
    interception runtime's folds).  One `torch.optim.Adam(lr)` over the whole
    [S, ...] tensors, as JAX's one optax state.

    Per step the best evaluated iterate is kept (the first epoch evaluates
    the init first), so the result is never worse than stage 1 on the
    objective at any step.  Returns (states', losses [epochs * S] floats)."""
    sel = [n for n in qstates if not attention_focus or _is_attn(n)]
    t_rev = [float(t) for t in reversed(list(seq))]
    S = xs_in.shape[0]
    theta = {}
    if train_alpha:
        theta["alpha"] = {k: qstates[k].alpha_logits.detach().clone() for k in sel}
    if train_range_scale:
        theta["rho"] = {k: torch.zeros(S, dtype=torch.float32, device=xs_in.device) for k in sel}
    if not theta:
        return qstates, []
    leaves = [v.requires_grad_(True) for fields in theta.values() for v in fields.values()]
    best = {kind: {k: v.detach().clone() for k, v in fields.items()} for kind, fields in theta.items()}
    best_loss = torch.full((S,), float("inf"), device=xs_in.device)
    opt = torch.optim.Adam(leaves, lr=lr)
    losses = []
    for _ep in range(epochs):
        for s in range(S):
            loss = _teacher_matched_loss(qunet, forward_params, qstates, theta, xs_in[s], eps_ref[s], t_rev[s], s,
                                         serving_extras=serving_extras, symmetric=symmetric, rank1=rank1)
            opt.zero_grad()
            loss.backward()
            with torch.no_grad():
                # keep the iterate this loss was evaluated at where it is the step's best so far (no host sync)
                better = loss < best_loss[s]
                for kind, fields in theta.items():
                    for k, v in fields.items():
                        best[kind][k][s] = torch.where(better, v[s], best[kind][k][s])
                best_loss[s] = torch.minimum(best_loss[s], loss)
            opt.step()
            losses.append(loss.detach())
    return _apply_theta(qstates, best), torch.stack(losses).tolist()


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


# ---------------------------------------------------------------------------
# Calibration-set generation (all four t-modes)
# ---------------------------------------------------------------------------


def alpha_uncertainty(qstates: Dict[str, ActQuantState], num_steps: int):
    """Per-step alpha entropy summed over every quantized conv, [num_steps]:
    each layer's -sum(p log p) over the channels of the softmax over the
    groups, its mean over the groups, / C."""
    u = None
    for st in qstates.values():
        p = torch.softmax(st.alpha_logits, dim=1)  # [S, G, C]
        ent = -(p * torch.log(p + 1e-12)).sum(dim=-1).mean(dim=1) / st.alpha_logits.shape[-1]
        u = ent if u is None else u + ent
    return torch.zeros(num_steps) if u is None else u


def select_calibration_images(xs_full, t_mode: str, *, num_steps: int, generator: torch.Generator | None = None,
                              normals=None, qstates: Dict[str, ActQuantState] | None = None, sample_count=None,
                              sample_weight: float = 2.0, min_t: int = 30):
    """Calibration inputs from a teacher trajectory `xs_full` [S+1, N, H, W,
    C] (x_init, then each step's x_t_next), by t-mode:

    - "real": the last entry;
    - "range": image i from entry min(i, S);
    - "random": image i from step clip(int((z_i * 0.4 + 0.4) * S), 0, S - 1),
      z the [N] `normals` (e.g. JAX's `jax.random.normal(key, (N,))`) or
      drawn from `generator`;
    - "diff": the step of the largest alpha uncertainty less `sample_weight`
      times its `sample_count`, over the steps from `min_t` on (clamped to
      the schedule: the reference's 30 assumes more steps), the last one of
      a tie.

    Returns (images [N, H, W, C], the selected step (a 0-d tensor) or None,
    sample_count updated)."""
    n = xs_full.shape[1]
    last = xs_full.shape[0] - 1
    rows = torch.arange(n, device=xs_full.device)
    if t_mode == "real":
        return xs_full[-1], None, sample_count
    if t_mode == "range":
        return xs_full[torch.clamp(rows, max=last), rows], None, sample_count
    if t_mode == "random":
        z = normals if normals is not None else _draw((n,), generator, xs_full.device)
        t = torch.clamp(((torch.as_tensor(z, device=xs_full.device) * 0.4 + 0.4) * num_steps).to(torch.int64),
                        0, num_steps - 1)
        return xs_full[t, rows], None, sample_count
    if t_mode == "diff":
        if qstates is None:
            raise ValueError("t_mode 'diff' needs the stage-1 qstates")
        min_t = max(0, min(min_t, num_steps - 1))
        dev = xs_full.device
        if sample_count is None:
            sample_count = torch.zeros(num_steps, device=dev)
        u = (alpha_uncertainty(qstates, num_steps).to(dev) - sample_weight * sample_count)[min_t:]
        t_sel = (u.shape[0] - 1 - torch.argmax(u.flip(0))) + min_t  # the last argmax of a tie
        sample_count = sample_count.index_add(0, t_sel.reshape(1), torch.ones(1, device=dev))
        x = xs_full.index_select(0, torch.clamp(t_sel, max=last).reshape(1))[0]
        return x, t_sel, sample_count
    raise NotImplementedError(t_mode)
