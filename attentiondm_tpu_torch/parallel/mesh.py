"""A mesh of ranks and the batch's placement on it (port of
`attentiondm_tpu/parallel/mesh.py`).

JAX's mesh is an array of the devices one process drives, and a
`NamedSharding` tells XLA where each slice of an array lives.  Here each
rank is one process with one device: a `Mesh` names the rank's coordinate
on each axis and holds one process group per axis (the ranks that share
every other coordinate), and placing a batch means taking this rank's
slice of it.  Ranks are laid out data-major, as JAX orders the devices of a
reshaped mesh: rank r sits at (r // model, r % model) on a (data, model)
mesh.  Without a process group the world is one rank and every helper
returns its input.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import world


@dataclasses.dataclass
class Mesh:
    """`shape` {axis: size} in axis order; `coords` {axis: this rank's index};
    `groups` {axis: the process group along it, None where its size is 1};
    `ranks` the mesh's global ranks, data-major."""
    shape: dict
    coords: dict
    groups: dict
    ranks: tuple

    @property
    def axes(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)


def _groups(ranks: np.ndarray, axes, me: int) -> dict:
    """One new_group per line of the rank array along each axis (every rank
    takes part in every call, in the same order); this rank's line per axis."""
    out = {}
    for i, axis in enumerate(axes):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
        mine = None
        for line in lines:
            g = dist.new_group([int(r) for r in line]) if len(line) > 1 else None
            if me in line:
                mine = g
        out[axis] = mine
    return out


def make_mesh(num_devices: int | None = None, axes: Sequence[str] = ("data",),
              shape: Sequence[int] | None = None) -> Mesh:
    """A 1-D (or reshaped N-D) mesh over the first `num_devices` ranks (all
    of them by default).

    `shape` pins the split per axis (e.g. (2, 4) for dp 2 x tp 4); without
    it a 2-D mesh favours the data axis with model = 2.  More devices than
    the world, or a shape that does not cover them, raise ValueError."""
    me, n_world = world()
    n = n_world
    if num_devices is not None:
        if num_devices > n_world:
            raise ValueError(f"requested {num_devices} devices, have {n_world}")
        n = num_devices
    axes = tuple(axes)
    if shape is not None:
        if len(shape) != len(axes) or int(np.prod(shape)) != n:
            raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} devices / axes {axes}")
        shape = tuple(int(s) for s in shape)
    elif len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        model = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // model, model)
    else:
        raise ValueError("1-D or 2-D meshes only (pass `shape` for more)")
    ranks = np.arange(n).reshape(shape)
    groups = _groups(ranks, axes, me) if n_world > 1 else {a: None for a in axes}
    pos = np.argwhere(ranks == me)
    coords = dict(zip(axes, (int(c) for c in pos[0]))) if len(pos) else {}
    return Mesh(shape=dict(zip(axes, shape)), coords=coords, groups=groups, ranks=tuple(range(n)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where the slices of an array live: `spec[i]` is the mesh axis (or
    tuple of axes) its dimension i is split over, None where it is whole."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """The leading (batch) dimension split over the data axis."""
    return Sharding(mesh, (axis,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def local_slice(x, mesh: Mesh, axis: str, dim: int = 0):
    """This rank's contiguous slice of `x` along `dim`, split over `axis`
    (x itself where the axis has one rank)."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not divide over the {n} ranks of {axis!r}")
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * step, step)


def shard_batch(mesh: Mesh, x, axis: str = "data"):
    """This rank's contiguous slice of the global batch `x` (data-major, as
    JAX's device order places it)."""
    return local_slice(x, mesh, axis, 0)


def replicate(mesh: Mesh, tree):
    """Every tensor leaf of `tree` as data-rank 0 holds it, on every rank
    (each axis's rank 0 broadcasts along it)."""
    from ..models.unet import map_tree
    from .collectives import broadcast

    def bcast(t):
        if not torch.is_tensor(t):
            return t
        for axis, g in mesh.groups.items():
            if g is not None:
                t = broadcast(t, dist.get_global_rank(g, 0), g)
        return t

    return map_tree(bcast, tree)
