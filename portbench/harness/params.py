"""Weights and inputs of a run, drawn on the device from the seed.

Every leaf of the reference's `param_layout` is drawn in one pass: one
uniform draw covers every "uniform:<fan_in>" leaf (U(+-1/sqrt(fan_in)), the
init of the layers' own frameworks), sliced and scaled leaf by leaf; the
GroupNorm scales are ones and the biases zeros.  The program and the
reference receive the same tensors.
"""
from __future__ import annotations

import math

import torch


def _leaves(layout, path=()):
    if isinstance(layout, dict):
        for k, v in layout.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(layout, list):
        for i, v in enumerate(layout):
            yield from _leaves(v, path + (i,))
    else:
        yield path, layout


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(layout):
    if isinstance(layout, dict):
        return {k: _skeleton(v) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_skeleton(v) for v in layout]
    return None


def draw_params(layout, generator: torch.Generator, device):
    """The parameter tree of `layout` (float32 on `device`), its uniform
    leaves from one draw of `generator`."""
    leaves = list(_leaves(layout))
    total = sum(math.prod(shape) for _p, (shape, init) in leaves if init.startswith("uniform:"))
    flat = torch.rand(total, generator=generator, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    tree, at = _skeleton(layout), 0
    for path, (shape, init) in leaves:
        n = math.prod(shape)
        if init.startswith("uniform:"):
            leaf = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(int(init.split(":", 1)[1])))
            at += n
        elif init in ("ones", "zeros"):
            leaf = (torch.ones if init == "ones" else torch.zeros)(shape, device=device, dtype=torch.float32)
        else:
            raise ValueError(f"unknown init {init!r} at {path}")
        _put(tree, path, leaf)
    return tree


def count(layout) -> int:
    return sum(math.prod(shape) for _p, (shape, _init) in _leaves(layout))


def seeded(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of a run's draws: weights 0,
    calibration images 1, the calls' noise 2 + call index.  Any whole seed is
    taken (reduced to the generator's 63 bits with the stream mixed in)."""
    mixed = (int(seed) * 1_000_003 + int(stream) * 7_919) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)
