"""Image distributions made on the device, for training without a dataset
(port of `attentiondm_tpu/data/synthetic.py`).

`synthetic_batch`: smooth two-tone Fourier backgrounds under up to four
anti-aliased circles and boxes.  `natural_batch`: 1/f^alpha noise in an
opponent colour basis with a lognormal contrast and up to three sharp
occluders, the activation statistics of natural photographs.  Both give
NHWC float32 in [-1, 1], the model's data domain.

Each distribution is two functions: `*_draws(generator, batch)` draws every
random number an image needs from a torch.Generator (on its device), and
`*_images(draws, res)` makes the images from them, so that a test can hand
in the draws JAX's `jax.random` keys give and compare the images.
"""
from __future__ import annotations

import math

import torch

N_SHAPES = 4  # the procedural composite's depth
N_OCCLUDERS = 3  # the natural images' occluders

# opponent colour basis (rows): luminance, red-green, blue-yellow; and each component's relative sd
_COLOR_BASIS = ((0.5774, 0.5774, 0.5774), (0.7071, 0.0, -0.7071), (0.4082, -0.8165, 0.4082))
_COLOR_SD = (1.0, 0.40, 0.15)


def _uniform(g, shape, lo, hi):
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def _shape_draws(g, batch, n, p_on):
    return {"center": _uniform(g, (batch, n, 2), 0.15, 0.85), "size": _uniform(g, (batch, n, 2), 0.08, 0.3),
            "is_circle": torch.rand((batch, n), generator=g, device=g.device) < 0.5,
            "color": _uniform(g, (batch, n, 3), -1.0, 1.0),
            "on": torch.rand((batch, n), generator=g, device=g.device) < p_on}


def _grid(res, device):
    lin = torch.linspace(0.0, 1.0, res, device=device)
    return torch.meshgrid(lin, lin, indexing="ij")  # yy, xx: [res, res]


def _composite(img, d, res):
    """Shape after shape (centre [B, n, 2] as (y, x), size (radius or half
    height, half width), is_circle, colour, on) over img [B, res, res, 3]:
    mask * colour + (1 - mask) * img, the mask a sigmoid of the signed
    distance over a 1.5-pixel band."""
    yy, xx = _grid(res, img.device)
    aa = 1.5 / res
    for i in range(d["center"].shape[1]):
        cy, cx = (d["center"][:, i, j, None, None] for j in (0, 1))
        sy, sx = (d["size"][:, i, j, None, None] for j in (0, 1))
        d_circle = torch.hypot(yy - cy, xx - cx) - sy
        d_box = torch.maximum(torch.abs(yy - cy) - sy, torch.abs(xx - cx) - sx)
        dist = torch.where(d["is_circle"][:, i, None, None], d_circle, d_box)
        mask = torch.sigmoid(-dist / aa)[..., None] * d["on"][:, i, None, None, None].to(torch.float32)
        img = mask * d["color"][:, i, None, None, :] + (1.0 - mask) * img
    return img


def synthetic_draws(generator: torch.Generator, batch: int) -> dict:
    """The procedural images' draws: background colours c0, c1 [B, 3] in
    [-1, 1], frequencies [B, 4] in [-2, 2], and N_SHAPES shapes (each present
    with p = 0.75, a circle with p = 0.5)."""
    g = generator
    return {"c0": _uniform(g, (batch, 3), -1.0, 1.0), "c1": _uniform(g, (batch, 3), -1.0, 1.0),
            "freq": _uniform(g, (batch, 4), -2.0, 2.0), **_shape_draws(g, batch, N_SHAPES, 0.75)}


def synthetic_images(d: dict, res: int = 32) -> torch.Tensor:
    """[B, res, res, 3] from `synthetic_draws`: c0 + (c1 - c0) * field, the
    field 0.5 + 0.5 cos(pi (f0 x + f1 y + f2 x y + f3)), under the shapes."""
    yy, xx = _grid(res, d["c0"].device)
    f = [d["freq"][:, j, None, None] for j in range(4)]
    phase = f[0] * xx + f[1] * yy + f[2] * xx * yy + f[3]
    field = 0.5 + 0.5 * torch.cos(math.pi * phase)
    c0, c1 = d["c0"][:, None, None, :], d["c1"][:, None, None, :]
    img = c0 + (c1 - c0) * field[..., None]
    return torch.clamp(_composite(img, d, res), -1.0, 1.0)


def synthetic_batch(generator: torch.Generator, batch: int, res: int = 32) -> torch.Tensor:
    """[batch, res, res, 3] float32 in [-1, 1] on the generator's device."""
    return synthetic_images(synthetic_draws(generator, batch), res)


def natural_draws(generator: torch.Generator, batch: int, res: int = 32) -> dict:
    """The natural images' draws: alpha [B] in [1.6, 2.4], white noise [B, 3,
    res, res], gain_z [B] and mean_z [B, 3] standard normal, and N_OCCLUDERS
    shapes (each present with p = 0.5)."""
    g = generator
    return {"alpha": _uniform(g, (batch,), 1.6, 2.4),
            "white": torch.randn((batch, 3, res, res), generator=g, device=g.device),
            "gain_z": torch.randn((batch,), generator=g, device=g.device),
            "mean_z": torch.randn((batch, 3), generator=g, device=g.device),
            **_shape_draws(g, batch, N_OCCLUDERS, 0.5)}


def natural_images(d: dict, res: int = 32) -> torch.Tensor:
    """[B, res, res, 3] from `natural_draws`: white noise filtered to
    1/f^alpha (unit RMS gain) in the opponent colour basis, scaled to unit
    sd, times a lognormal gain 0.45 exp(0.6 z) plus a mean colour 0.25 z,
    under the occluders, clipped."""
    dev = d["white"].device
    fy = torch.fft.fftfreq(res, device=dev)[:, None]
    fx = torch.fft.fftfreq(res, device=dev)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    amp = (f + 1.0 / res) ** (-d["alpha"][:, None, None] / 2.0)  # [B, res, res]
    amp = amp / torch.sqrt(torch.mean(amp * amp, dim=(1, 2), keepdim=True))
    pink = torch.fft.ifft2(torch.fft.fft2(d["white"]) * amp[:, None]).real  # [B, 3, res, res]
    sd = torch.tensor(_COLOR_SD, device=dev)
    basis = torch.tensor(_COLOR_BASIS, device=dev)
    img = torch.einsum("bcij,cd->bijd", pink * sd[:, None, None], basis)
    img = img / (torch.std(img, dim=(1, 2, 3), correction=0, keepdim=True) + 1e-6)
    gain = 0.45 * torch.exp(0.6 * d["gain_z"])
    img = img * gain[:, None, None, None] + (0.25 * d["mean_z"])[:, None, None, :]
    return torch.clamp(_composite(img, d, res), -1.0, 1.0)


def natural_batch(generator: torch.Generator, batch: int, res: int = 32) -> torch.Tensor:
    """[batch, res, res, 3] float32 in [-1, 1] with natural-image statistics, on the generator's device."""
    return natural_images(natural_draws(generator, batch, res), res)
