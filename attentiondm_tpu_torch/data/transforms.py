"""Model-space transforms of images (port of the transforms of
`attentiondm_tpu/data/transforms.py`; the datasets are `data/datasets.py`).

Images are float32 NHWC tensors in [0, 1]; `data_transform` maps them to
model space (dequantization, logit or rescale to [-1, 1]) and
`inverse_data_transform` maps model outputs back to [0, 1].
`inverse_transform_uint8` goes straight to uint8 pixels on the tensor's
device, so a bulk run moves a quarter of the bytes to the host.
"""
from __future__ import annotations

import torch


def logit_transform(image, lam: float = 1e-6):
    image = lam + (1 - 2 * lam) * image
    return torch.log(image) - torch.log1p(-image)


def data_transform(config, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Model-space images; the dequantization draws (where the config asks
    for them) come from `generator`."""
    d = config.data
    x = x.to(torch.float32)

    def draw(fn):
        if generator is None:
            raise ValueError("dequantization draws need generator= (a torch.Generator)")
        return fn(x.shape, generator=generator, device=generator.device).to(x.device)

    if getattr(d, "uniform_dequantization", False):
        x = (x * 255.0 + draw(torch.rand)) / 256.0
    if getattr(d, "gaussian_dequantization", False):
        x = x + draw(torch.randn) * 0.01
    if getattr(d, "rescaled", False):
        x = 2 * x - 1.0
    elif getattr(d, "logit_transform", False):
        x = logit_transform(x)
    return x


def _to_unit(config, x: torch.Tensor) -> torch.Tensor:
    d = config.data
    x = x.to(torch.float32)
    if getattr(d, "logit_transform", False):
        return 1.0 / (1.0 + torch.exp(-x))
    if getattr(d, "rescaled", False):
        return (x + 1.0) / 2.0
    return x


def inverse_data_transform(config, x: torch.Tensor) -> torch.Tensor:
    """Model outputs -> float32 images in [0, 1]."""
    return torch.clamp(_to_unit(config, x), 0.0, 1.0)


def inverse_transform_uint8(config, x: torch.Tensor) -> torch.Tensor:
    """Model outputs -> uint8 pixels on x's device: clip to [0, 1], * 255 +
    0.5, truncated (`utils.images.to_uint8`'s rounding)."""
    return (inverse_data_transform(config, x) * 255.0 + 0.5).to(torch.uint8)
