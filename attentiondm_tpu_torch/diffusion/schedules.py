"""Diffusion noise schedules (port of `attentiondm_tpu/diffusion/schedules.py`).

Computed in float64 numpy once, then frozen into float32 tensors on the
caller's device (`device=None`: the package's `default_device()`).  All six
schedules of the JAX package (quad, linear, const, jsd, sigmoid and cosine,
the one imagenet64.yml names) and both variances (fixedlarge, fixedsmall).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import default_device


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """betas[T] (float64 numpy) for the named schedule: quad | linear | const
    | jsd | sigmoid | cosine (Nichol & Dhariwal 2021: alpha_bar(t) =
    cos^2((t/T + s)/(1+s) * pi/2), s = 0.008, betas clipped to [0, 0.999])."""
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    elif beta_schedule == "cosine":
        s = 0.008
        steps = np.arange(T + 1, dtype=np.float64)
        alpha_bar = np.cos(((steps / T) + s) / (1 + s) * math.pi / 2) ** 2
        betas = np.clip(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0.0, 0.999)
    else:
        raise NotImplementedError(f"beta_schedule={beta_schedule!r}: no such schedule")
    if betas.shape != (T,):
        raise ValueError(f"beta schedule {beta_schedule!r}: {betas.shape} betas for {T} steps")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule tensors, all shape [T] float32.  `logvar`:
    fixedlarge -> log(beta), fixedsmall -> log(posterior variance clamped at
    1e-20)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    logvar: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @staticmethod
    def create(beta_schedule: str, beta_start: float, beta_end: float,
               num_diffusion_timesteps: int, device=None, var_type: str = "fixedlarge") -> "DiffusionSchedule":
        device = default_device() if device is None else device
        betas = get_beta_schedule(beta_schedule, beta_start=beta_start, beta_end=beta_end,
                                  num_diffusion_timesteps=num_diffusion_timesteps)
        alphas_cumprod = np.cumprod(1.0 - betas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        if var_type == "fixedlarge":
            logvar = np.log(betas)
        elif var_type == "fixedsmall":
            posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            logvar = np.log(np.maximum(posterior_variance, 1e-20))
        else:
            raise NotImplementedError(f"var_type={var_type!r}: fixedlarge or fixedsmall")

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return DiffusionSchedule(betas=f32(betas), alphas_cumprod=f32(alphas_cumprod), logvar=f32(logvar))

    @classmethod
    def from_config(cls, config, device=None) -> "DiffusionSchedule":
        """From a config namespace (`config.load_config`): its `diffusion`
        group and the model's `var_type`."""
        d = config.diffusion
        return cls.create(d.beta_schedule, d.beta_start, d.beta_end, d.num_diffusion_timesteps, device=device,
                          var_type=getattr(config.model, "var_type", "fixedlarge"))


def compute_alpha(betas: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """alpha_bar at integer index t, with t = -1 mapping to 1 (zero prepended)."""
    betas = torch.cat([torch.zeros(1, dtype=betas.dtype, device=betas.device), betas])
    a = torch.cumprod(1.0 - betas, dim=0)
    return a[t + 1]
