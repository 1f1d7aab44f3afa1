"""Asymmetric linear quantization primitives (port of
`attentiondm_tpu/quant/primitives.py`).

Signed asymmetric quantization: scale = (2^b - 1)/(max - min), zero point
round(scale * min) + 2^(b-1), q = clip(round(scale * x - zp)).  `torch.round`
rounds half to even, like `jnp.round`.  Ranges broadcast along the trailing
(channel) axis.  Rounding passes its gradient straight through (`ste_round`,
`ste_floor`); `clip` cuts it outside the range and halves it on the bounds,
as `jnp.clip` (a maximum then a minimum) does.
"""
from __future__ import annotations

import torch


def div(num: float, t):
    """num / t as a true division.  torch computes `scalar / tensor` as
    `scalar * reciprocal(tensor)`, which can land 1 ulp off the quotient that
    JAX (and IEEE division) gives; the fold's rounding ties notice."""
    return torch.full_like(t, num) / t


def lp_loss(pred, tgt, p: float = 2.0, reduction: str = "none"):
    """L_p-norm calibration loss."""
    d = torch.abs(pred - tgt) ** p
    if reduction == "none":
        return d.sum(dim=1).mean()
    return d.mean()


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _SteFloor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.floor(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x):
    """round (half to even) with a straight-through gradient."""
    return _SteRound.apply(x)


def ste_floor(x):
    """floor with a straight-through gradient: the AdaRound fold's rounding
    (floor + learned offset), made differentiable for the serving surrogate."""
    return _SteFloor.apply(x)


def clip(x, lo, hi):
    """x clipped to [lo, hi] (numbers or tensors).  Where a gradient is being
    recorded it is `jnp.clip`'s: maximum then minimum, whose gradient is
    halved where x equals a bound (torch.clamp passes it whole there)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    lo, hi = (b if torch.is_tensor(b) else x.new_full((), b) for b in (lo, hi))
    return torch.minimum(torch.maximum(x, lo), hi)


def asymmetric_quant_params(num_bits: int, sat_min, sat_max):
    """(scale, zero_point) for signed asymmetric quantization, with an
    integral zero point."""
    scale = div(2 ** num_bits - 1, torch.as_tensor(sat_max - sat_min))
    return scale, torch.round(scale * sat_min) + 2 ** (num_bits - 1)


def fake_quant(x, num_bits: int, sat_min, sat_max, ste: bool = True):
    """Quantize-dequantize x at `num_bits` with the given saturation range.
    With `ste` the rounding passes its gradient straight through and the
    clip cuts it outside the range."""
    scale, zp = asymmetric_quant_params(num_bits, sat_min, sat_max)
    n = 2 ** (num_bits - 1)
    q = clip((ste_round if ste else torch.round)(scale * x - zp), -n, n - 1)
    return (q + zp) / scale


def quantize_int(x, scale, zp, num_bits: int, dtype=torch.int8):
    """True integer quantization: round, clamp, cast."""
    n = 2 ** (num_bits - 1)
    return torch.clamp(torch.round(scale * x - zp), -n, n - 1).to(dtype)


def dequantize_int(q, scale, zp, dtype=torch.float32):
    return (q.to(dtype) + zp) / scale


def percentile_range(x, percentile: float = 0.9999):
    """(low, high) percentile-clipped range of a tensor (linear
    interpolation, as `jnp.quantile`)."""
    flat = x.reshape(-1)
    return torch.quantile(flat, 1.0 - percentile), torch.quantile(flat, percentile)
