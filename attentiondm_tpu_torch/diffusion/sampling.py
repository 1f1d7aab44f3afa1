"""DDIM and DDPM samplers (port of `attentiondm_tpu/diffusion/sampling.py`).

The JAX `lax.scan` becomes a Python loop over steps.  Nothing inside the loop
reads a value back to the host, so the device runs the steps back to back.

The model callable is ``model_fn(x, t, step_idx) -> eps`` with NHWC `x`, a
[N] float32 timestep vector `t` and the integer position `step_idx` within
the reversed sequence.

JAX draws a stochastic sampler's noise from a `jax.random.split` chain,
which torch cannot reproduce: here it comes from an explicit
`torch.Generator`, or is handed in per step (`noise=`, the draws
themselves, the way a test feeds JAX's draws to the port).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .schedules import compute_alpha


def make_timestep_seq(num_timesteps: int, steps: int, skip_type: str = "uniform") -> np.ndarray:
    """Sub-sampled increasing timestep sequence (quad: linspace(0, sqrt(0.8 T))^2)."""
    if steps > num_timesteps:
        raise ValueError(f"steps ({steps}) cannot exceed num_timesteps ({num_timesteps})")
    if skip_type == "uniform":
        skip = num_timesteps // steps
        if num_timesteps % steps == 0:
            seq = np.arange(0, num_timesteps, skip)
        else:
            seq = np.unique(np.floor(np.linspace(0, num_timesteps - skip, steps)).astype(np.int64))
            assert len(seq) == steps, (num_timesteps, steps)
    elif skip_type == "uniform_ref":
        seq = np.arange(0, num_timesteps, num_timesteps // steps)
    elif skip_type == "quad":
        seq = (np.linspace(0, np.sqrt(num_timesteps * 0.8), steps) ** 2).astype(np.int64)
    else:
        raise NotImplementedError(skip_type)
    return seq


def _seq_alphas(betas: torch.Tensor, seq: Sequence[int]):
    """Per-step (t, t_next, alpha_bar_t, alpha_bar_next) for the reversed sequence."""
    seq = np.asarray(list(seq), dtype=np.int64)
    seq_next = np.concatenate([[-1], seq[:-1]])
    t_rev = torch.as_tensor(seq[::-1].copy(), device=betas.device)
    tn_rev = torch.as_tensor(seq_next[::-1].copy(), device=betas.device)
    return t_rev, tn_rev, compute_alpha(betas, t_rev), compute_alpha(betas, tn_rev)


def draw_noise(i: int, like: torch.Tensor, generator: torch.Generator | None = None, noise=None):
    """The standard normals of sampler step `i`, shaped like `like`: `noise[i]`
    where the caller hands the draws in (a [S, N, H, W, C] tensor or a list of
    S tensors, e.g. JAX's split-chain draws), else a draw from `generator` (on
    the generator's device, moved to `like`'s).  Without either it raises:
    a stochastic sampler never draws from torch's global state."""
    if noise is not None:
        return torch.as_tensor(noise[i]).to(device=like.device, dtype=like.dtype)
    if generator is None:
        raise ValueError("a stochastic sampler needs generator= (a torch.Generator) or noise= (the draws)")
    return torch.randn(like.shape, generator=generator, device=generator.device, dtype=like.dtype).to(like.device)


def ddim_step(xt, et, at, at_next, eta, noise):
    """One generalized (DDIM) update; returns (xt_next, x0_t)."""
    x0_t = (xt - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
    c1 = eta * torch.sqrt((1.0 - at / at_next) * (1.0 - at_next) / (1.0 - at))
    c2 = torch.sqrt((1.0 - at_next) - c1 ** 2)
    xt_next = torch.sqrt(at_next) * x0_t + c1 * noise + c2 * et
    return xt_next, x0_t


def ddpm_step(xt, et, at, atm1, t, noise):
    """One ancestral (DDPM) update; returns (sample, x0_from_e).  x0 is
    clipped to [-1, 1], and the noise is masked off at t == 0 (`t` the
    integer timestep)."""
    beta_t = 1.0 - at / atm1
    x0_from_e = torch.sqrt(1.0 / at) * xt - torch.sqrt(1.0 / at - 1.0) * et
    x0_from_e = torch.clamp(x0_from_e, -1.0, 1.0)
    mean = (torch.sqrt(atm1) * beta_t * x0_from_e + torch.sqrt(1.0 - beta_t) * (1.0 - atm1) * xt) / (1.0 - at)
    mask = (torch.as_tensor(t) > 0).to(xt.dtype)
    sample = mean + mask * torch.exp(0.5 * torch.log(beta_t)) * noise
    return sample, x0_from_e


def step_rule(update: str, eta: float = 0.0, generator: torch.Generator | None = None, noise=None):
    """The per-step update `(i, xt, et, t, at, at_next) -> (x_next, x0)` of
    "ddim" (noised at `eta` > 0) or "ddpm" (always noised; `eta` unused),
    its noise from `draw_noise`.  Every sampler of the package steps with it.
    A model output wider than x (ADM's `learn_sigma`: eps, then the
    variance's channels) gives its first channels as eps."""

    def rule(i, xt, et, t, at, at_next):
        if et.shape[-1] != xt.shape[-1]:
            et = et[..., :xt.shape[-1]]
        if update == "ddpm":
            return ddpm_step(xt, et, at, at_next, t, draw_noise(i, xt, generator, noise))
        e = draw_noise(i, xt, generator, noise) if eta > 0 else torch.zeros_like(xt)
        return ddim_step(xt, et, at, at_next, eta, e)

    return rule


def _run(rule, model_fn, x, seq, betas, keep_trajectory):
    t_rev, _, at, at_next = _seq_alphas(betas, seq)
    n = x.shape[0]
    xs, x0s = [], []
    for i in range(t_rev.shape[0]):
        et = model_fn(x, t_rev[i].to(torch.float32).expand(n), i)
        x, x0_t = rule(i, x, et, t_rev[i], at[i], at_next[i])
        if keep_trajectory:
            xs.append(x)
            x0s.append(x0_t)
    if keep_trajectory:
        return x, torch.stack(xs), torch.stack(x0s)
    return x


def ddim_sample(model_fn: Callable, x: torch.Tensor, seq: Sequence[int], betas: torch.Tensor, *,
                eta: float = 0.0, generator: torch.Generator | None = None, noise=None,
                keep_trajectory: bool = False):
    """Run the DDIM trajectory; at eta > 0 each step adds eta-scaled noise
    (`draw_noise`: from `generator`, or step i's entry of `noise`).

    Returns x_final, or (x_final, xs [S, N, H, W, C], x0_preds) with
    `keep_trajectory` (the calibration set is built from `xs`)."""
    return _run(step_rule("ddim", eta, generator, noise), model_fn, x, seq, betas, keep_trajectory)


def ddpm_sample(model_fn: Callable, x: torch.Tensor, seq: Sequence[int], betas: torch.Tensor, *,
                generator: torch.Generator | None = None, noise=None, keep_trajectory: bool = False):
    """Ancestral DDPM sampling along `seq`; every step draws its noise
    (`draw_noise`), the last one masks it off."""
    return _run(step_rule("ddpm", generator=generator, noise=noise), model_fn, x, seq, betas, keep_trajectory)
