"""DDIM sampler (port of `attentiondm_tpu/diffusion/sampling.py`).

The JAX `lax.scan` becomes a Python loop over steps.  Nothing inside the loop
reads a value back to the host, so the device runs the steps back to back.

The model callable is ``model_fn(x, t, step_idx) -> eps`` with NHWC `x`, a
[N] float32 timestep vector `t` and the integer position `step_idx` within
the reversed sequence.
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


def check_eta(eta: float):
    if eta != 0:
        raise NotImplementedError(
            f"eta={eta!r}: stochastic DDIM sampling is not ported yet; it comes with ROADMAP "
            "Queue 1, 'runner/CLI, eval, data, parallel and tools'")


def ddim_step(xt, et, at, at_next, eta, noise):
    """One generalized (DDIM) update; returns (xt_next, x0_t)."""
    x0_t = (xt - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
    c1 = eta * torch.sqrt((1.0 - at / at_next) * (1.0 - at_next) / (1.0 - at))
    c2 = torch.sqrt((1.0 - at_next) - c1 ** 2)
    xt_next = torch.sqrt(at_next) * x0_t + c1 * noise + c2 * et
    return xt_next, x0_t


def ddim_sample(model_fn: Callable, x: torch.Tensor, seq: Sequence[int], betas: torch.Tensor, *,
                eta: float = 0.0, keep_trajectory: bool = False):
    """Run the deterministic (eta = 0) DDIM trajectory.

    Returns x_final, or (x_final, xs [S, N, H, W, C], x0_preds) with
    `keep_trajectory` (the calibration set is built from `xs`)."""
    check_eta(eta)
    t_rev, _, at, at_next = _seq_alphas(betas, seq)
    n = x.shape[0]
    xs, x0s = [], []
    for i in range(t_rev.shape[0]):
        t_vec = t_rev[i].to(torch.float32).expand(n)
        et = model_fn(x, t_vec, i)
        x, x0_t = ddim_step(x, et, at[i], at_next[i], 0.0, torch.zeros_like(x))
        if keep_trajectory:
            xs.append(x)
            x0s.append(x0_t)
    if keep_trajectory:
        return x, torch.stack(xs), torch.stack(x0s)
    return x
