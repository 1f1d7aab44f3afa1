"""InceptionV3, the FID variant (port of `attentiondm_tpu/eval/inception.py`).

The canonical FID feature network (pytorch-fid's InceptionV3 with the FID
pooling variants and the `pt_inception-2015-12-05` weights), NHWC in and
`channels_last` inside.  The operations are JAX's: BatchNorm from running
statistics as `(x - mean) * rsqrt(var + 1e-3) * scale + bias`, the 3x3 max
pool at stride 2 (VALID), the 3x3 average pool that does not count the
padding, the 1x7 / 7x1 / 1x3 / 3x1 branches zero-padded along their long
axis, Mixed_7b's average pool and Mixed_7c's max pool.

Input is float [0, 1] NHWC at any resolution: bilinearly resized to 299
(half-pixel centres; antialiased where the input is larger, as
`jax.image.resize` is), rescaled to [-1, 1], and mean-pooled after the last
block into 2048-d features.  Eval mode only; float32 on a CUDA device runs
under `ops.precision.exact_f32()` (cuDNN's TF32 would move the features).

The network holds its parameters as a tree (`inception_init`,
`load_torch_inception`, `from_jax_params`) in torch's layout: each conv's
kernel OIHW, each BatchNorm's `scale`, `bias`, `mean`, `var`.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import default_device
from ..ops.precision import exact_f32

BN_EPS = 1e-3

# (name, type, spec): a basic conv (cin, cout, k, stride, pad), a 3x3 / 2 max pool, or a block of type A to E
_LAYOUT = [
    ("Conv2d_1a_3x3", "basic", (3, 32, 3, 2, 0)),
    ("Conv2d_2a_3x3", "basic", (32, 32, 3, 1, 0)),
    ("Conv2d_2b_3x3", "basic", (32, 64, 3, 1, 1)),
    ("maxpool1", "maxpool", None),
    ("Conv2d_3b_1x1", "basic", (64, 80, 1, 1, 0)),
    ("Conv2d_4a_3x3", "basic", (80, 192, 3, 1, 0)),
    ("maxpool2", "maxpool", None),
    ("Mixed_5b", "A", (192, 32)),
    ("Mixed_5c", "A", (256, 64)),
    ("Mixed_5d", "A", (288, 64)),
    ("Mixed_6a", "B", (288,)),
    ("Mixed_6b", "C", (768, 128)),
    ("Mixed_6c", "C", (768, 160)),
    ("Mixed_6d", "C", (768, 160)),
    ("Mixed_6e", "C", (768, 192)),
    ("Mixed_7a", "D", (768,)),
    ("Mixed_7b", "E", (1280, "avg")),
    ("Mixed_7c", "E", (2048, "max")),
]


def _block_convs(btype, spec):
    """{branch: (cin, cout, k)} of a block of type A to E."""
    if btype == "A":
        cin, pf = spec
        return {"branch1x1": (cin, 64, 1), "branch5x5_1": (cin, 48, 1), "branch5x5_2": (48, 64, 5),
                "branch3x3dbl_1": (cin, 64, 1), "branch3x3dbl_2": (64, 96, 3), "branch3x3dbl_3": (96, 96, 3),
                "branch_pool": (cin, pf, 1)}
    if btype == "B":
        (cin,) = spec
        return {"branch3x3": (cin, 384, 3), "branch3x3dbl_1": (cin, 64, 1), "branch3x3dbl_2": (64, 96, 3),
                "branch3x3dbl_3": (96, 96, 3)}
    if btype == "C":
        cin, c7 = spec
        return {"branch1x1": (cin, 192, 1), "branch7x7_1": (cin, c7, 1), "branch7x7_2": (c7, c7, (1, 7)),
                "branch7x7_3": (c7, 192, (7, 1)), "branch7x7dbl_1": (cin, c7, 1), "branch7x7dbl_2": (c7, c7, (7, 1)),
                "branch7x7dbl_3": (c7, c7, (1, 7)), "branch7x7dbl_4": (c7, c7, (7, 1)),
                "branch7x7dbl_5": (c7, 192, (1, 7)), "branch_pool": (cin, 192, 1)}
    if btype == "D":
        (cin,) = spec
        return {"branch3x3_1": (cin, 192, 1), "branch3x3_2": (192, 320, 3), "branch7x7x3_1": (cin, 192, 1),
                "branch7x7x3_2": (192, 192, (1, 7)), "branch7x7x3_3": (192, 192, (7, 1)),
                "branch7x7x3_4": (192, 192, 3)}
    if btype == "E":
        cin, _pool = spec
        return {"branch1x1": (cin, 320, 1), "branch3x3_1": (cin, 384, 1), "branch3x3_2a": (384, 384, (1, 3)),
                "branch3x3_2b": (384, 384, (3, 1)), "branch3x3dbl_1": (cin, 448, 1),
                "branch3x3dbl_2": (448, 384, 3), "branch3x3dbl_3a": (384, 384, (1, 3)),
                "branch3x3dbl_3b": (384, 384, (3, 1)), "branch_pool": (cin, 192, 1)}
    raise ValueError(btype)


def _conv_sites():
    """(block, branch or None, (cin, cout, k)) of every conv, in JAX's init order."""
    for name, btype, spec in _LAYOUT:
        if btype == "basic":
            yield name, None, spec[:3]
        elif btype != "maxpool":
            for branch, conv in _block_convs(btype, spec).items():
                yield name, branch, conv


def _node(params, name, branch):
    return params[name] if branch is None else params[name][branch]


def _set_node(params, name, branch, node):
    if branch is None:
        params[name] = node
    else:
        params.setdefault(name, {})[branch] = node


def _bn_identity(cout, device):
    return {"scale": torch.ones(cout, device=device), "bias": torch.zeros(cout, device=device),
            "mean": torch.zeros(cout, device=device), "var": torch.ones(cout, device=device)}


def inception_init(generator: torch.Generator, device=None) -> Dict:
    """Seeded random weights from `generator` (a CPU torch.Generator): He
    normals, std sqrt(2 / fan_in), drawn conv by conv in JAX's order as
    [kh, kw, cin, cout] (JAX's `_init_basic` distributions, not its
    numbers); BatchNorm the identity.  On `device` (None: the package's
    `default_device()`)."""
    device = default_device() if device is None else device
    params = {}
    for name, branch, (cin, cout, k) in _conv_sites():
        kh, kw = k if isinstance(k, tuple) else (k, k)
        std = math.sqrt(2.0 / (kh * kw * cin))
        w = torch.randn((kh, kw, cin, cout), generator=generator) * std
        _set_node(params, name, branch, {"conv": {"kernel": w.permute(3, 2, 0, 1).contiguous().to(device)},
                                         "bn": _bn_identity(cout, device)})
    return params


def from_jax_params(tree, device=None) -> Dict:
    """JAX's Inception tree (numpy leaves; kernels HWIO) -> the port's (OIHW),
    on `device` (None: the package's `default_device()`)."""
    device = default_device() if device is None else device
    params = {}
    for name, branch, _conv in _conv_sites():
        node = _node(tree, name, branch)
        k = torch.tensor(np.asarray(node["conv"]["kernel"])).permute(3, 2, 0, 1).contiguous()
        bn = {f: torch.tensor(np.asarray(node["bn"][f])).float().to(device) for f in ("scale", "bias", "mean", "var")}
        _set_node(params, name, branch, {"conv": {"kernel": k.float().to(device)}, "bn": bn})
    return params


def load_torch_inception(path: str, device=None) -> Dict:
    """The `pt_inception-2015-12-05` (or torchvision inception_v3) state dict
    at `path`, read with `weights_only=True`, mapped by name:
    `<block>.<branch>.conv.weight` and `.bn.{weight, bias, running_mean,
    running_var}`, on `device` (None: the package's `default_device()`).
    A missing key raises KeyError."""
    device = default_device() if device is None else device
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    params = {}
    for name, branch, _conv in _conv_sites():
        prefix = name if branch is None else f"{name}.{branch}"
        w = sd.get(f"{prefix}.conv.weight")
        if w is None:
            raise KeyError(f"missing {prefix}.conv.weight in {path}")
        bn = {ours: sd[f"{prefix}.bn.{theirs}"].float().to(device)
              for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                                   ("var", "running_var"))}
        _set_node(params, name, branch, {"conv": {"kernel": w.float().contiguous().to(device)}, "bn": bn})
    return params


# ---------------------------------------------------------------------------
# forward (NCHW tensors in channels_last memory)
# ---------------------------------------------------------------------------


def _basic(x, p, stride=1, padding=(0, 0)):
    y = F.conv2d(x, p["conv"]["kernel"], stride=stride, padding=padding)
    bn = p["bn"]
    inv = torch.rsqrt(bn["var"] + BN_EPS)
    return F.relu((y - bn["mean"][:, None, None]) * inv[:, None, None] * bn["scale"][:, None, None]
                  + bn["bias"][:, None, None])


def _maxpool3(x):
    return F.max_pool2d(x, 3, stride=2)


def _avgpool3_noinc(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _inception_a(x, p):
    b1 = _basic(x, p["branch1x1"])
    b5 = _basic(_basic(x, p["branch5x5_1"]), p["branch5x5_2"], padding=(2, 2))
    b3 = _basic(x, p["branch3x3dbl_1"])
    b3 = _basic(_basic(b3, p["branch3x3dbl_2"], padding=(1, 1)), p["branch3x3dbl_3"], padding=(1, 1))
    bp = _basic(_avgpool3_noinc(x), p["branch_pool"])
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(x, p):
    b3 = _basic(x, p["branch3x3"], stride=2)
    bd = _basic(_basic(x, p["branch3x3dbl_1"]), p["branch3x3dbl_2"], padding=(1, 1))
    bd = _basic(bd, p["branch3x3dbl_3"], stride=2)
    return torch.cat([b3, bd, _maxpool3(x)], dim=1)


def _inception_c(x, p):
    b1 = _basic(x, p["branch1x1"])
    b7 = _basic(x, p["branch7x7_1"])
    b7 = _basic(_basic(b7, p["branch7x7_2"], padding=(0, 3)), p["branch7x7_3"], padding=(3, 0))
    bd = _basic(x, p["branch7x7dbl_1"])
    for i, pad in ((2, (3, 0)), (3, (0, 3)), (4, (3, 0)), (5, (0, 3))):
        bd = _basic(bd, p[f"branch7x7dbl_{i}"], padding=pad)
    bp = _basic(_avgpool3_noinc(x), p["branch_pool"])
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(x, p):
    b3 = _basic(_basic(x, p["branch3x3_1"]), p["branch3x3_2"], stride=2)
    b7 = _basic(x, p["branch7x7x3_1"])
    b7 = _basic(_basic(b7, p["branch7x7x3_2"], padding=(0, 3)), p["branch7x7x3_3"], padding=(3, 0))
    b7 = _basic(b7, p["branch7x7x3_4"], stride=2)
    return torch.cat([b3, b7, _maxpool3(x)], dim=1)


def _inception_e(x, p, pool: str):
    b1 = _basic(x, p["branch1x1"])
    b3 = _basic(x, p["branch3x3_1"])
    b3 = torch.cat([_basic(b3, p["branch3x3_2a"], padding=(0, 1)), _basic(b3, p["branch3x3_2b"], padding=(1, 0))],
                   dim=1)
    bd = _basic(_basic(x, p["branch3x3dbl_1"]), p["branch3x3dbl_2"], padding=(1, 1))
    bd = torch.cat([_basic(bd, p["branch3x3dbl_3a"], padding=(0, 1)),
                    _basic(bd, p["branch3x3dbl_3b"], padding=(1, 0))], dim=1)
    # the FID variant: Mixed_7b pools by average, Mixed_7c by max
    bp = _avgpool3_noinc(x) if pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
    return torch.cat([b1, b3, bd, _basic(bp, p["branch_pool"])], dim=1)


_BLOCKS = {"A": _inception_a, "B": _inception_b, "C": _inception_c, "D": _inception_d}


def resize_299(x):
    """[N, C, H, W] -> [N, C, 299, 299], bilinear at half-pixel centres,
    antialiased when the input is larger than 299 (as `jax.image.resize`'s
    triangle kernel widens when it shrinks)."""
    if tuple(x.shape[2:]) == (299, 299):
        return x
    shrink = x.shape[2] > 299 or x.shape[3] > 299
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=shrink)


def inception_apply(params: Dict, x: torch.Tensor, *, resize_input: bool = True,
                    normalize_input: bool = True) -> torch.Tensor:
    """x: [N, H, W, 3] float in [0, 1] -> features [N, 2048] float32."""
    with exact_f32():
        x = x.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if resize_input:
            x = resize_299(x).contiguous(memory_format=torch.channels_last)
        if normalize_input:
            x = 2.0 * x - 1.0
        for name, btype, spec in _LAYOUT:
            if btype == "maxpool":
                x = _maxpool3(x)
            elif btype == "basic":
                _cin, _cout, _k, stride, pad = spec
                x = _basic(x, params[name], stride=stride, padding=(pad, pad))
            elif btype == "E":
                x = _inception_e(x, params[name], spec[1])
            else:
                x = _BLOCKS[btype](x, params[name])
        return x.mean(dim=(2, 3))


class _Basic(nn.Module):
    """One conv + BatchNorm's tensors, as buffers."""

    def __init__(self, node):
        super().__init__()
        self.register_buffer("kernel", node["conv"]["kernel"].contiguous(memory_format=torch.channels_last))
        for f in ("scale", "bias", "mean", "var"):
            self.register_buffer(f, node["bn"][f])

    def tree(self):
        return {"conv": {"kernel": self.kernel}, "bn": {f: getattr(self, f) for f in ("scale", "bias", "mean", "var")}}


class InceptionV3FID(nn.Module):
    """The feature extractor: `extract(x01_nhwc) -> [N, 2048]` (also its
    `forward`).  `.to(device)` moves it; `params` is its tree."""

    def __init__(self, params: Dict):
        super().__init__()
        layers = nn.ModuleDict()
        for name, btype, _spec in _LAYOUT:
            if btype == "basic":
                layers[name] = _Basic(params[name])
            elif btype != "maxpool":
                layers[name] = nn.ModuleDict({b: _Basic(node) for b, node in params[name].items()})
        self.layers = layers
        self.eval()

    @classmethod
    def random(cls, seed: int = 0, device=None) -> "InceptionV3FID":
        return cls(inception_init(torch.Generator().manual_seed(seed), device))

    @classmethod
    def from_torch(cls, path: str, device=None) -> "InceptionV3FID":
        return cls(load_torch_inception(path, device))

    @property
    def params(self) -> Dict:
        out = {}
        for name, mod in self.layers.items():
            out[name] = mod.tree() if isinstance(mod, _Basic) else {b: m.tree() for b, m in mod.items()}
        return out

    @torch.no_grad()
    def extract(self, x):
        return inception_apply(self.params, x)

    def forward(self, x):
        return self.extract(x)
