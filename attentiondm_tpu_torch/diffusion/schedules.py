"""Diffusion noise schedules (port of `attentiondm_tpu/diffusion/schedules.py`).

Computed in float64 numpy once, then frozen into float32 tensors on the
caller's device (`device=None`: the package's `default_device()`).  Only the linear schedule, the one the serving path uses,
is ported; the others raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """betas[T] (float64 numpy) for the named schedule."""
    T = num_diffusion_timesteps
    if beta_schedule != "linear":
        raise NotImplementedError(
            f"beta_schedule={beta_schedule!r}: only 'linear' is ported; the other "
            "schedules come with ROADMAP Queue 1, 'runner/CLI, eval, data, parallel and tools'"
        )
    return np.linspace(beta_start, beta_end, T, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule tensors, all shape [T] float32."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    logvar: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @staticmethod
    def create(beta_schedule: str, beta_start: float, beta_end: float,
               num_diffusion_timesteps: int, device=None) -> "DiffusionSchedule":
        device = default_device() if device is None else device
        betas = get_beta_schedule(beta_schedule, beta_start=beta_start, beta_end=beta_end,
                                  num_diffusion_timesteps=num_diffusion_timesteps)
        alphas_cumprod = np.cumprod(1.0 - betas)
        logvar = np.log(betas)  # the "fixedlarge" variance

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return DiffusionSchedule(betas=f32(betas), alphas_cumprod=f32(alphas_cumprod), logvar=f32(logvar))

    @classmethod
    def from_config(cls, config, device=None) -> "DiffusionSchedule":
        """From a config namespace (`config.load_config`): its `diffusion`
        group; the model's `var_type` must be "fixedlarge", the variance
        `create` computes."""
        d = config.diffusion
        var_type = getattr(config.model, "var_type", "fixedlarge")
        if var_type != "fixedlarge":
            raise NotImplementedError(
                f"var_type={var_type!r}: only 'fixedlarge' is ported; the others come with ROADMAP "
                "Queue 1, 'runner/CLI, eval, data, parallel and tools'")
        return cls.create(d.beta_schedule, d.beta_start, d.beta_end, d.num_diffusion_timesteps, device=device)


def compute_alpha(betas: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """alpha_bar at integer index t, with t = -1 mapping to 1 (zero prepended)."""
    betas = torch.cat([torch.zeros(1, dtype=betas.dtype, device=betas.device), betas])
    a = torch.cumprod(1.0 - betas, dim=0)
    return a[t + 1]
