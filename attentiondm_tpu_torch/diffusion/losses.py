"""Training loss (port of `attentiondm_tpu/diffusion/losses.py`)."""
from __future__ import annotations

import torch


def noise_estimation_loss(model_fn, x0, t, e, betas, keepdim: bool = False):
    """Epsilon-prediction MSE: x = x0 sqrt(a_bar_t) + e sqrt(1 - a_bar_t),
    the squared error of `model_fn(x, t.float())` against e summed over H, W
    and C, then averaged over the batch (`keepdim`: the per-image sums).
    `t` is an integer [N] tensor.  Returns (loss, model output)."""
    a = torch.cumprod(1.0 - betas, dim=0)[t].reshape(-1, 1, 1, 1)
    x = x0 * torch.sqrt(a) + e * torch.sqrt(1.0 - a)
    output = model_fn(x, t.to(torch.float32))
    se = torch.square(e - output).sum(dim=(1, 2, 3))
    if keepdim:
        return se, output
    return se.mean(), output


loss_registry = {"simple": noise_estimation_loss}
