"""Tensor- and spatial-parallel UNets (port of `attentiondm_tpu/parallel/tp.py`).

JAX annotates the param tree with PartitionSpecs on a 2-D (data, model)
mesh and lets GSPMD insert the collectives.  Here each rank holds its own
shard of the params (`shard_unet_params`) or its own rows of the images
(`shard_batch_spatial`), and `unet_apply(parallel=UNetParallel(...))` runs
the collectives of `collectives.py` where GSPMD would put them.

Tensor parallelism (Megatron's pairing, one all-reduce per resblock, two
per attention block):

  resblock   conv1, temb_proj   column-parallel (output channels split)
             norm2              split over C (the degree divides the 32
                                groups, so a shard holds whole groups)
             conv2              row-parallel (input channels split; its
                                output all-reduced, then the bias added)
             norm1, shortcut    replicated
  attention  q, k, v            column-parallel (the logits all-reduced
             (query/key/value)  over the split C before the softmax)
             proj_out           row-parallel
             (output_conv)
  temb MLP, conv_in / conv_out, norm_out, up / downsample: replicated.

Spatial parallelism splits the image height over `model` and keeps the
params whole: each 3x3 conv reads one halo row from each neighbour (zeros at
the image's edges), the stride-2 downsample the first row of the rank
below (zeros on the last rank, its (0, 1) pad), GroupNorm all-reduces its
per-group sums over `model`, attention gathers K and V over `model`, and the
loss's mean is taken over the whole mesh (`training.make_sharded_train_step`).
Level 0's height must divide over the ranks (ValueError otherwise, as JAX's
`device_put` of the input refuses it).  Where a rank's rows of a level are
odd before its downsample, GSPMD pads; here the rows are gathered over
`model` before that downsample (`sp_levels`), the levels below run whole on
every rank with the plain ops (no halo, no all-reduced sums, dense
attention), and each rank takes its rows back after the matching upsample.
The gather's backward sums the ranks' gradients (a reduce-scatter); the
replicated levels' parameter gradients each hold only this rank's rows'
share of the loss, so the mesh's all-reduce counts them once.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import collectives as col
from .mesh import Mesh, local_slice

# parameter-tree leaves routed by the NAME of their enclosing module (JAX's lists)
_COLUMN = ("conv1", "temb_proj", "q", "k", "v", "query_conv", "key_conv", "value_conv")
_ROW = ("conv2", "proj_out", "output_conv")
_SHARDED_NORM = ("norm2",)


def _spec_for(path_names, leaf):
    """The split dimension of one param leaf given its key path, or None."""
    mod = next((n for n in reversed(path_names) if n not in ("kernel", "bias", "scale")), "")
    name = path_names[-1]
    if mod in _COLUMN:
        # conv HWIO -> O; dense (cin, cout) -> cout; the bias lives on the split output channels
        return leaf.ndim - 1 if name == "kernel" else 0
    if mod in _ROW:
        # conv HWIO -> I; dense (cin, cout) -> cin; the bias applies after the all-reduce, whole
        return leaf.ndim - 2 if name == "kernel" else None
    if mod in _SHARDED_NORM:
        return 0
    return None


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _keystr(path) -> str:
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path)


def unet_param_specs(params, axis: str = "model"):
    """A tree like `params` holding each leaf's split dimension over `axis`
    (None: replicated).  `axis` names the mesh axis the specs refer to."""
    return _map_with_path(lambda path, leaf: _spec_for(list(path), leaf), params)


def _check_divisibility(params, specs, m: int):
    def check(path, leaf):
        dim = _lookup(specs, path)
        if dim is not None and leaf.shape[dim] % m:
            raise ValueError(f"{_keystr(path)}: dim {dim} ({leaf.shape[dim]}) not divisible by tp degree {m}")
    _map_with_path(check, params)


def _lookup(tree, path):
    for p in path:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def shard_unet_params(mesh: Mesh, params, axis: str = "model"):
    """This rank's shard of every param leaf under the tensor-parallel specs.

    GroupNorm's statistics need no communication only when the degree
    divides the 32 groups (a contiguous C shard then holds whole groups):
    checked here rather than found as a wrong answer, as is every split
    dimension's divisibility."""
    m = mesh.shape[axis]
    if 32 % m:
        raise ValueError(f"tp degree {m} must divide the 32 GroupNorm groups")
    specs = unet_param_specs(params, axis)
    _check_divisibility(params, specs, m)
    i = mesh.index(axis)

    def shard(path, leaf):
        dim = _lookup(specs, path)
        if dim is None or m == 1:
            return leaf
        n = leaf.shape[dim] // m
        return leaf.narrow(dim, i * n, n).contiguous()

    return _map_with_path(shard, params)


def gather_unet_params(mesh: Mesh, local, specs, axis: str = "model"):
    """The whole leaves of a tree of shards (`shard_unet_params`' inverse),
    on every rank of the axis."""
    g = mesh.groups.get(axis)

    def whole(path, leaf):
        dim = _lookup(specs, path)
        if dim is None or g is None:
            return leaf
        return torch.cat(col.all_gather(leaf, g), dim=dim)

    return _map_with_path(whole, local)


def shard_batch_spatial(mesh: Mesh, x, *, data_axis: str = "data", spatial_axis: str = "model"):
    """This rank's slice of NHWC activations over batch (data) and image
    height (model)."""
    return local_slice(local_slice(x, mesh, data_axis, 0), mesh, spatial_axis, 1)


def sp_levels(cfg, size: int) -> int:
    """The first level of `cfg` that sp over `size` ranks runs replicated
    (`len(cfg.ch_mult)`: none): the level after the first whose rows a rank
    are odd, since a stride-2 downsample of an odd slice straddles two
    ranks.  Level 0's height must divide over the ranks (ValueError)."""
    levels = len(cfg.ch_mult)
    res = cfg.resolution
    if res % size:
        raise ValueError(f"level 0 ({res}x{res}): its height does not divide over the {size} ranks of sp "
                         f"(JAX's device_put of the input under P(data, model) refuses it too)")
    for lvl in range(levels - 1):
        if (res // size) % 2:
            return lvl + 1
        res //= 2
    return levels


def describe_sp(cfg, size: int) -> str:
    """The sp plan in words: which levels split their rows and which run whole."""
    rep, levels = sp_levels(cfg, size), len(cfg.ch_mult)
    res = [cfg.resolution >> i for i in range(levels)]
    split = ", ".join(f"{i} ({r}x{r}, {r // size} row(s) a rank)" for i, r in enumerate(res[:rep]))
    whole = ", ".join(f"{i} ({r}x{r})" for i, r in enumerate(res) if i >= rep) or "none"
    return f"sp {size}: levels split over the ranks {split}; levels replicated on every rank {whole}"


def sharded_fraction(params, specs) -> float:
    """Share of the parameter BYTES that carry a split dimension."""
    tot = sh = 0

    def count(path, leaf):
        nonlocal tot, sh
        n = leaf.numel() * leaf.element_size()
        tot += n
        if _lookup(specs, path) is not None:
            sh += n
    _map_with_path(count, params)
    return sh / max(tot, 1)


@dataclasses.dataclass
class UNetParallel:
    """The `parallel=` context of `unet_apply`: `mode` "tp" (params are this
    rank's shards) or "sp" (x is this rank's rows of the images), over the
    `model` process `group` of `size` ranks.  Every hook below is where the
    forward's collectives go."""
    mode: str
    group: object
    size: int

    @classmethod
    def of(cls, mesh: Mesh, mode: str, axis: str = "model"):
        """The context over `axis` of `mesh`; None where the axis has one
        rank (the forward is then the plain one)."""
        if mode not in ("tp", "sp"):
            raise ValueError(f"parallel mode must be 'tp' or 'sp', got {mode!r}")
        if mesh.shape.get(axis, 1) == 1:
            return None
        return cls(mode=mode, group=mesh.groups[axis], size=mesh.shape[axis])

    @property
    def tp(self) -> bool:
        return self.mode == "tp"

    @property
    def sp(self) -> bool:
        return self.mode == "sp"

    # --- tensor parallelism --------------------------------------------------
    def column_in(self, x):
        """A replicated input of a column-parallel layer (f)."""
        return col.copy_in(x, self.group) if self.tp else x

    def norm_groups(self, sharded: bool) -> int:
        """The GroupNorm groups a (possibly channel-split) norm sees locally."""
        return 32 // self.size if sharded and self.tp else 32

    def row_conv(self, conv_apply, name, h, p):
        """A row-parallel conv: partial sums, all-reduced (g), then the bias."""
        if not self.tp:
            return conv_apply(name, h, p)
        out = conv_apply(name, h, {"kernel": p["kernel"], "bias": torch.zeros_like(p["bias"])})
        return col.reduce_out(out, self.group) + p["bias"]

    def attention(self, q, kT, v, scale):
        """softmax(q kT * scale) v in float32 where q, kT, v are split: over
        channels (tp: the logits all-reduced, g; the weights enter the split
        product through f) or over query rows (sp: K and V gathered over the
        group)."""
        if self.tp:
            w = torch.softmax(col.reduce_out(torch.matmul(q.float(), kT.float()), self.group) * scale, dim=-1)
            return torch.matmul(col.copy_in(w, self.group), v.float())
        kT, v = col.gather(kT, 2, self.group), col.gather(v, 1, self.group)
        w = torch.softmax(torch.matmul(q.float(), kT.float()) * scale, dim=-1)
        return torch.matmul(w, v.float())

    # --- spatial parallelism -------------------------------------------------
    def conv(self, conv_apply):
        """`conv_apply` with a halo row from each neighbour before each 3x3
        stride-1 SAME conv (sp), else `conv_apply` itself."""
        if not self.sp:
            return conv_apply

        def ca(name, x, p, *, stride=1, padding="SAME"):
            if padding == "SAME" and p["kernel"].shape[0] == 3:
                x = F.pad(col.halo(x, 1, 1, self.group), (0, 0, 1, 1))
                padding = "VALID"
            return conv_apply(name, x, p, stride=stride, padding=padding)

        return ca

    def pad_down(self, x):
        """The stride-2 downsample's (0, 1) pad under sp: the bottom row is
        the first row of the rank below (zeros on the last rank)."""
        return F.pad(col.halo(x, 0, 1, self.group), (0, 0, 0, 1))

    def group_norm(self, x, p, num_groups: int = 32, eps: float = 1e-6):
        """GroupNorm with its per-group sums all-reduced over the rows' ranks
        (sp), in float32, two passes (the mean, then the centred squares)."""
        dtype = x.dtype
        N, C = x.shape[0], x.shape[-1]
        g = min(num_groups, C)
        xg = x.to(torch.float32).reshape(N, -1, g, C // g)
        count = xg.shape[1] * xg.shape[3] * self.size
        mean = col.reduce_sum(xg.sum(dim=(1, 3), keepdim=True), self.group) / count
        d = xg - mean
        var = col.reduce_sum((d * d).sum(dim=(1, 3), keepdim=True), self.group) / count
        x = (d * torch.rsqrt(var + eps)).reshape(x.shape)
        return (x * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(dtype)

    def check_rows(self, cfg) -> int:
        """The first level the forward runs replicated (`sp_levels`; tp and
        an sp plan without one: `len(cfg.ch_mult)`).  Raises ValueError where
        level 0's height does not divide over the sp ranks."""
        return sp_levels(cfg, self.size) if self.sp else len(cfg.ch_mult)

    def gather_rows(self, x):
        """The whole image from every rank's rows (sp), before the first
        replicated level; backward, each rank's rows of the summed gradient."""
        return col.gather(x, 1, self.group)

    def local_rows(self, x):
        """This rank's rows of a whole (replicated) image, after the last
        replicated level's upsample."""
        h = x.shape[1] // self.size
        return x.narrow(1, dist.get_rank(self.group) * h, h)
