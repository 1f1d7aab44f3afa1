"""Adaptive weight rounding (AdaRound) and bias correction for low-bit folds
(port of `attentiondm_tpu/quant/adaround.py`).

Per-output-channel round-to-nearest with an MSE range shrink is the ceiling
of plain rounding at W4.  Two serving-compatible upgrades change the fold,
never the kernels:

- **AdaRound** (Nagel et al. 2020, arXiv:2004.10568): learn each weight's
  round-up / round-down decision against the layer's *output*
  reconstruction error, through the layer-input Gram H = E[x_patch
  x_patch^T]:

      min_h  sum_n (W_hat(h) - W)[:, n]^T H (W_hat(h) - W)[:, n]
             + lam * f_reg(h),   h in [0, 1]^{K x N}

  with the rectified-sigmoid parameterization and the annealed |2h-1|^beta
  regularizer pushing h to {0, 1}.  `optax.adam(1e-2)` becomes
  `torch.optim.Adam(lr=1e-2)`, with the same anneal and warm-up.
- **Bias correction**: the quantized weights shift the expected output by
  E[x]^T (W_hat - W); the fold subtracts it from the epilogue constant.

The optimizers (this one and `quant/gptq.py`) take a stack of layers of one
shape at once: each layer's problem is its own (its loss term, its Adam
moments), and a stack runs each step as one batched product.  The Gram, the
optimizers and the bias means run in full float32 (`exact_f32`): TF32 would
move the Gram in its 10th bit.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet import UNetConfig, conv2d, iter_conv_layers, lookup, unet_apply
from ..ops.precision import exact_f32
from ..ops.quant_conv import fold_shrink_search, weight_grid
from .primitives import clip, div

# Layers up to this K (= kh*kw*cin; H is K^2 floats) are collected in one
# joint forward pass.  4800 covers every CIFAR-10 layer (max K = 9*512).
GRAM_K_CAP = 4800
# Layers above GRAM_K_CAP are collected in extra memory-budgeted passes; only
# layers above this hard cap keep round-to-nearest, with a warning.
# 18432 = 9*2048 covers imagenet64's widest up-block conv1.
GRAM_K_MAX = 18432
# Bytes of f32 Gram per large-K collection pass, and per stack of layers an
# optimizer takes at once.
GRAM_CHUNK_BYTES = 1 << 30


def _pack_gram_chunks(large, k_of, chunk_bytes):
    """Group layer names into passes of <= chunk_bytes of f32 Gram each.  A
    layer whose Gram alone exceeds the budget gets a pass of its own: the
    budget bounds how many Grams coexist, it never drops a layer."""
    chunks, cur, used = [], [], 0
    for n in large:
        b = 4 * k_of[n] ** 2
        if cur and used + b > chunk_bytes:
            chunks.append(cur)
            cur, used = [], 0
        cur.append(n)
        used += b
    if cur:
        chunks.append(cur)
    return chunks


@dataclasses.dataclass
class ConvStats:
    """Accumulated input statistics of one conv.

    gram  [K, K]  sum of x_patch x_patch^T over the calibration pixels (a
                  zero [1, 1] placeholder when K is over the pass's cap)
    mu    [K]     sum of x_patch (divide by count for the mean)
    count []      number of accumulated patches
    """

    gram: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _im2col(x, ksize: int):
    """NHWC -> [B*H*W, kh*kw*C] patches in (dy, dx, c) order: the row order
    of `ops.quant_conv.fold_weights_int8`'s flattened HWIO kernel."""
    B, H, W, C = x.shape
    if ksize == 1:
        return x.reshape(B * H * W, C)
    assert ksize == 3
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + H, dx:dx + W, :] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(B * H * W, 9 * C)


def init_conv_stats(cfg: UNetConfig, device, names: Sequence[str] | None = None,
                    k_cap: int = GRAM_K_CAP) -> Dict[str, ConvStats]:
    """Zero stats for every (selected) conv of the UNet, on `device`."""
    f32 = dict(dtype=torch.float32, device=device)
    out = {}
    for name, cin, k in iter_conv_layers(cfg):
        if names is not None and name not in names:
            continue
        K = k * k * cin
        d = K if K <= k_cap else 1
        out[name] = ConvStats(gram=torch.zeros((d, d), **f32), mu=torch.zeros((K,), **f32),
                              count=torch.zeros((), **f32))
    return out


@exact_f32()
@torch.no_grad()
def collect_conv_stats(params, cfg: UNetConfig, xs, seq: Sequence[int], *, max_steps: int = 8,
                       names: Sequence[str] | None = None, k_cap: int = GRAM_K_CAP) -> Dict[str, ConvStats]:
    """Accumulate per-layer input Grams and sums over evenly spaced steps of
    the calibration trajectory `xs` [S, N, H, W, C] (the FP teacher's model
    inputs; the float forward is the standard AdaRound proxy)."""
    t_rev = np.asarray(list(seq))[::-1].astype(np.float32)
    S = xs.shape[0]
    sel = np.unique(np.linspace(0, S - 1, min(max_steps, S)).astype(int))
    stats = init_conv_stats(cfg, xs.device, names, k_cap)

    def conv_apply(name, xin, pp, *, stride=1, padding="SAME"):
        kh = pp["kernel"].shape[0]
        st = stats.get(name)
        if st is not None and stride == 1 and kh in (1, 3):
            pat = _im2col(xin.to(torch.float32), kh)
            if st.gram.shape[0] == pat.shape[1]:
                st.gram += pat.T @ pat
            st.mu += pat.sum(dim=0)
            st.count += float(pat.shape[0])
        return conv2d(xin, pp, stride=stride, padding=padding)

    for i in sel:
        unet_apply(params, cfg, xs[i], torch.full((xs.shape[1],), float(t_rev[i]), device=xs.device),
                   conv_apply=conv_apply)
    return stats


# ---------------------------------------------------------------------------
# the AdaRound optimization
# ---------------------------------------------------------------------------

_GAMMA, _ZETA = -0.1, 1.1  # rectified-sigmoid stretch (AdaRound paper, section 3)


def _h_of(v):
    return clip(torch.sigmoid(v) * (_ZETA - _GAMMA) + _GAMMA, 0.0, 1.0)


def _grid(g, w_bit: int, symmetric: bool, shrink):
    """`weight_grid` of each layer of a [L, K, N] stack: (ws, wzp) [L, 1, N]."""
    ws, wzp = zip(*(weight_grid(g[i], w_bit, symmetric, shrink[i]) for i in range(g.shape[0])))
    return torch.stack(ws)[:, None, :], torch.stack(wzp)[:, None, :]


def _stacked(fn):
    """Let a core written for a [L, K, N] stack take one [K, N] layer."""
    def run(g, gram, shrink, **kw):
        if g.ndim == 3:
            return fn(g, gram, shrink, **kw)
        return fn(g[None], gram[None], shrink[None], **kw)[0]

    run.__doc__ = fn.__doc__
    return run


@_stacked
@exact_f32()
def _adaround_opt(g, gram, shrink, *, w_bit: int, symmetric: bool, iters: int):
    """Rounding decisions of scale-folded weight matrices.

    g      [L, K, N]  scale-folded weights (kernel / act_scale, flattened HWIO)
    gram   [L, K, K]  input Grams (normalized)
    shrink [L, N]     per-channel range shrinks (the grid the fold uses)
    (or one layer without the L axis).  Returns h [L, K, N] in {0, 1}."""
    n = 2 ** (w_bit - 1)
    ws, wzp = _grid(g, w_bit, symmetric, shrink)  # the fold's grid, so the offsets mean the same there
    base = ws * g - wzp
    fl = torch.floor(base)
    r = torch.clamp(base - fl, 1e-4, 1.0 - 1e-4)
    v0 = -torch.log(div(_ZETA - _GAMMA, r - _GAMMA) - 1.0)  # h(v0) == r: soft rounding starts at the value

    def recon(h):  # [L]
        d = (clip(fl + h, -n, n - 1) + wzp) / ws - g
        return torch.sum(d * (gram @ d), dim=(1, 2))

    with torch.no_grad():
        e_rtn = torch.clamp(recon((r > 0.5).to(g.dtype)), min=1e-30)
    v = v0.clone().requires_grad_(True)
    opt = torch.optim.Adam([v], lr=1e-2)
    with torch.enable_grad():
        for i in range(iters):
            frac = np.float32(i) / np.float32(iters)
            beta = float(np.float32(20.0) - np.float32(18.0) * frac)  # anneal 20 -> 2
            reg_w = 0.1 if frac > np.float32(0.2) else 0.0  # warm-up: the data term alone
            h = _h_of(v)
            reg = torch.mean(1.0 - torch.abs(2.0 * h - 1.0) ** beta, dim=(1, 2))
            loss = torch.sum(recon(h) / e_rtn + reg_w * reg)  # each layer's gradient is its own term's
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    with torch.no_grad():
        return (_h_of(v) > 0.5).to(torch.float32)


def _folded(kernel, act_scale):
    """kernel / act_scale, flattened HWIO: [K, co]."""
    kh, kw, ci, co = kernel.shape
    return (kernel / act_scale.reshape(1, 1, ci, 1)).reshape(kh * kw * ci, co).to(torch.float32)


def _has_gram(kernel, stats: ConvStats) -> bool:
    return stats.gram.shape[0] == int(np.prod(kernel.shape[:3])) and float(stats.count) > 0


def _normalized(stats: ConvStats):
    return stats.gram / torch.clamp(stats.count, min=1.0)


def _shrink_of(kernel, act_scale, w_bit, symmetric, shrink):
    co = kernel.shape[3]
    if shrink is None:
        shrink = fold_shrink_search(kernel, act_scale, w_bit, symmetric)
    return torch.broadcast_to(torch.as_tensor(shrink, dtype=torch.float32, device=kernel.device), (co,))


def adaround_offsets(kernel, act_scale, stats: ConvStats, w_bit: int, *, symmetric: bool = True, shrink=None,
                     iters: int = 1000):
    """Per-layer AdaRound: rounding offsets int16 [kh, kw, ci, co] in {0, 1},
    or None when the layer has no Gram (K over the cap, or no data)."""
    if not _has_gram(kernel, stats):
        return None
    h = _adaround_opt(_folded(kernel, act_scale), _normalized(stats),
                      _shrink_of(kernel, act_scale, w_bit, symmetric, shrink), w_bit=w_bit, symmetric=symmetric,
                      iters=iters)
    return h.reshape(kernel.shape).to(torch.int16)


@exact_f32()
@torch.no_grad()
def gram_objective(kernel, act_scale, stats: ConvStats, w_bit: int, shrink, round_offset=None, *,
                   symmetric: bool = True):
    """The quantity AdaRound and GPTQ lower: sum_n d_n^T H d_n over a layer's
    output channels, d = g_hat - g on the fold's grid of g = kernel /
    act_scale, H the normalized Gram; g_hat from `round_offset` (int16
    [kh, kw, ci, co]) or, without, round-to-nearest."""
    g = _folded(kernel, act_scale)
    n = 2 ** (w_bit - 1)
    ws, wzp = weight_grid(g, w_bit, symmetric, _shrink_of(kernel, act_scale, w_bit, symmetric, shrink))
    base = ws * g - wzp
    if round_offset is None:
        q = torch.clamp(torch.round(base), -n, n - 1)
    else:
        q = torch.clamp(torch.floor(base) + round_offset.reshape(g.shape).to(g.dtype), -n, n - 1)
    d = (q + wzp) / ws - g
    return torch.sum(d * (_normalized(stats) @ d))


# ---------------------------------------------------------------------------
# the whole pass: offsets and means for every serving-eligible layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WeightExtras:
    """Optional per-layer weight-quality artifacts the fold consumes.

    round_offset int16 [kh, kw, ci, co]: AdaRound ({0, 1}) or GPTQ (signed,
                 several levels) decisions, added to floor(ws*g - wzp); a
                 layer without them is missing from the dict or None here and
                 rounds to nearest.
    mu           [kh*kw*ci] mean im2col input row: the bias-correction vector.
    shrink       [co] the per-channel range shrink the offsets were optimized
                 against, pinned so the fold uses exactly that grid.
    out_mult     [co] (or [S, co] per step) multiplier on the decoded weight
                 (`calibrate.refine_weight_extras`); folds into the dequant
                 scale at no runtime cost.
    bias_delta   [co] (or [S, co] per step) additive bias refinement; folds
                 into the epilogue constant.
    """

    round_offset: torch.Tensor | None
    mu: torch.Tensor | None
    shrink: torch.Tensor | None = None
    out_mult: torch.Tensor | None = None
    bias_delta: torch.Tensor | None = None


def _eligible_kernels(qunet, params, qstates):
    """{name: kernel} of the serving-eligible convs that have states, in layer order."""
    from .int8_runtime import _eligible

    out = {}
    for name, _cin, _k in iter_conv_layers(qunet.cfg):
        kernel = lookup(params, name)["kernel"]
        if _eligible(kernel.shape) and name in qstates:
            out[name] = kernel
    return out


def collect_weight_stats(qunet, params, qstates, xs, seq: Sequence[int], *, max_steps: int = 8,
                         k_max: int = GRAM_K_MAX, chunk_bytes: int = GRAM_CHUNK_BYTES) -> Dict[str, ConvStats]:
    """The Gram collection of `compute_weight_extras`: every eligible layer
    up to GRAM_K_CAP in one pass of `max_steps` forwards, the layers up to
    `k_max` in extra passes of at most `chunk_bytes` of Gram each.  A layer
    over `k_max` keeps round-to-nearest (with a warning) and still gets its
    mean for the bias correction."""
    kernels = _eligible_kernels(qunet, params, qstates)
    k_of = {n: int(np.prod(k.shape[:3])) for n, k in kernels.items()}
    small = [n for n in kernels if k_of[n] <= GRAM_K_CAP]
    large = sorted((n for n in kernels if GRAM_K_CAP < k_of[n] <= k_max), key=lambda n: k_of[n])
    skipped = [n for n in kernels if k_of[n] > k_max]
    for n in skipped:
        logging.warning("weight_opt: %s K=%d exceeds k_max=%d — keeping round-to-nearest "
                        "(raise k_max / chunk_bytes to cover it)", n, k_of[n], k_max)
    # over-cap layers ride the base pass with a placeholder Gram: they keep mu
    stats = collect_conv_stats(params, qunet.cfg, xs, seq, max_steps=max_steps, names=small + skipped,
                               k_cap=GRAM_K_CAP)
    chunks = _pack_gram_chunks(large, k_of, chunk_bytes)
    for i, ch in enumerate(chunks):
        logging.info("weight_opt: large-K Gram pass %d/%d (%d layers, K up to %d)", i + 1, len(chunks), len(ch),
                     max(k_of[n] for n in ch))
        stats.update(collect_conv_stats(params, qunet.cfg, xs, seq, max_steps=max_steps, names=ch,
                                        k_cap=max(k_of[n] for n in ch)))
    return stats


def compute_weight_extras(qunet, params, qstates, xs, seq: Sequence[int], *, symmetric: bool = True,
                          iters: int = 1000, max_steps: int = 8, adaround_max_wbit: int = 6,
                          bias_correct: bool = True, method: str = "adaround", rank1: bool = False, progress=None,
                          k_max: int = GRAM_K_MAX, chunk_bytes: int = GRAM_CHUNK_BYTES,
                          stats: Dict[str, ConvStats] | None = None) -> Dict[str, WeightExtras]:
    """Collect the Gram stats on the calibration trajectory, then optimize
    the rounding of every serving-eligible layer at w_bit <=
    `adaround_max_wbit` (0: bias correction only) and package the
    bias-correction means.

    `method`: "adaround" (per-weight up / down decisions against the layer's
    output quadratic) or "gptq" (error-compensated rounding through the
    inverse-Hessian Cholesky, quant/gptq.py); both read the same Grams and
    emit fold offsets.  The grid is anchored on the fold's mean-over-steps
    activation scale, or with `rank1` on the rank-1 factor u[c]
    (quant/rank1.py), the shared fold's grid.  Layers of one shape are
    optimized together, at most `chunk_bytes` of Gram at a time.

    `stats` (from `collect_weight_stats` with the same arguments) skips the
    collection, so that several methods can share one."""
    from .gptq import _gptq_opt, _offsets_of  # gptq imports this module
    from .int8_runtime import _step_ranges
    from .rank1 import rank1_factors

    kernels = _eligible_kernels(qunet, params, qstates)
    if stats is None:
        stats = collect_weight_stats(qunet, params, qstates, xs, seq, max_steps=max_steps, k_max=k_max,
                                     chunk_bytes=chunk_bytes)
    scale, shrink = {}, {}
    for name, kernel in kernels.items():
        pol, st = qunet.policy[name], qstates[name]
        if rank1:
            scale[name] = rank1_factors(st, pol.a_bit)[0]
        else:
            scale[name] = _step_ranges(st.group_ranges, st.alpha_logits, pol.a_bit)[0].mean(dim=0)
        shrink[name] = fold_shrink_search(kernel, scale[name], pol.w_bit, symmetric)

    todo = [n for n in kernels if qunet.policy[n].w_bit <= adaround_max_wbit and _has_gram(kernels[n], stats[n])]
    offsets = {}
    groups = {}
    for n in todo:
        groups.setdefault((tuple(kernels[n].shape), qunet.policy[n].w_bit), []).append(n)
    k_of = {n: int(np.prod(kernels[n].shape[:3])) for n in todo}
    for (shape, w_bit), members in groups.items():
        for part in _pack_gram_chunks(members, k_of, chunk_bytes):
            g = torch.stack([_folded(kernels[n], scale[n]) for n in part])
            gram = torch.stack([_normalized(stats[n]) for n in part])
            sh = torch.stack([shrink[n] for n in part])
            if method == "gptq":
                offs = _offsets_of(_gptq_opt(g, gram, sh, w_bit=w_bit, symmetric=symmetric), g, sh, w_bit,
                                   symmetric)
            else:
                offs = _adaround_opt(g, gram, sh, w_bit=w_bit, symmetric=symmetric, iters=iters)
            for n, o in zip(part, offs):
                offsets[n] = o.reshape(shape).to(torch.int16)
            del g, gram

    out: Dict[str, WeightExtras] = {}
    for name in kernels:
        offs, mu = offsets.get(name), None
        if bias_correct and float(stats[name].count) > 0:
            mu = stats[name].mu / torch.clamp(stats[name].count, min=1.0)
        if offs is not None or mu is not None:
            out[name] = WeightExtras(round_offset=offs, mu=mu, shrink=shrink[name])
        if progress is not None:
            progress(name, offs is not None)
    return out
