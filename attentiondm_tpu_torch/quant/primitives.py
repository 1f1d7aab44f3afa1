"""Asymmetric linear quantization primitives (port of
`attentiondm_tpu/quant/primitives.py`, forward only).

Signed asymmetric quantization: scale = (2^b - 1)/(max - min), zero point
round(scale * min) + 2^(b-1), q = clip(round(scale * x - zp)).  `torch.round`
rounds half to even, like `jnp.round`.  Ranges broadcast along the trailing
(channel) axis.
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


def asymmetric_quant_params(num_bits: int, sat_min, sat_max):
    """(scale, zero_point) for signed asymmetric quantization, with an
    integral zero point."""
    scale = div(2 ** num_bits - 1, torch.as_tensor(sat_max - sat_min))
    return scale, torch.round(scale * sat_min) + 2 ** (num_bits - 1)


def fake_quant(x, num_bits: int, sat_min, sat_max):
    """Quantize-dequantize x at `num_bits` with the given saturation range."""
    scale, zp = asymmetric_quant_params(num_bits, sat_min, sat_max)
    n = 2 ** (num_bits - 1)
    q = torch.clamp(torch.round(scale * x - zp), -n, n - 1)
    return (q + zp) / scale
