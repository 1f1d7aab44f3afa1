"""The collectives of the sharded forward, each with its backward rule.

GSPMD inserts JAX's collectives and differentiates them; here they are
explicit `torch.autograd.Function`s.  The convention is Megatron's: every
rank of a model group computes the loss on the same (replicated) values and
seeds its backward with it, so the gradient of a replicated tensor is the
same on every rank, and a sharded tensor's is its own shard's.

- `copy_in` (Megatron's f): identity forward, all-reduce backward.  It
  stands where a replicated tensor enters a sharded computation (the input
  of a column-parallel layer), whose ranks each see a part of its gradient.
- `reduce_out` (Megatron's g): all-reduce forward, identity backward.  It
  stands where a sharded computation's partial sums become a replicated
  value (a row-parallel layer's output, the attention logits summed over
  sharded channels).  `torch.distributed.nn.functional.all_reduce` would
  all-reduce the gradient too and multiply it by the group's size here.
- `reduce_sum`: all-reduce both ways: partial sums that every rank then
  applies to its own shard (spatial GroupNorm's statistics), f after g.
- `gather`: all-gather along a dimension forward, reduce-scatter backward
  (spatial attention's keys and values).
- `halo`: the rows a 3x3 conv reads across a spatial shard's edges, zeros at
  the image's edges; backward sends each halo row's gradient home.

The backend takes the tensors where they lie: NCCL a card's, gloo the CPU's
and, for ranks sharing one card, the card's too (gloo runs all_reduce,
broadcast and all_gather on CUDA tensors; chip_smoke.py's cifar10-parallel
path checks which collectives it takes).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, a new tensor on t's device."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (same shape on each), in the group's rank order."""
    src = t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` of the group's global rank `src`, on every rank (a new tensor)."""
    out = t.detach().clone().contiguous()
    dist.broadcast(out, src=src, group=group)
    return out


def broadcast_object(obj, device, src: int = 0):
    """`obj` as global rank `src` holds it, on every rank of the world:
    pickled by `torch.save` on `src`, its tensors loaded onto `device`
    elsewhere; `src` keeps its own `obj`."""
    import io

    box = [None]
    if dist.get_rank() == src:
        buf = io.BytesIO()
        torch.save(obj, buf)
        box[0] = buf.getvalue()
    dist.broadcast_object_list(box, src=src)
    if dist.get_rank() == src:
        return obj
    return torch.load(io.BytesIO(box[0]), map_location=device, weights_only=False)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return all_reduce(g.contiguous(), ctx.group).narrow(ctx.dim, me * ctx.n, ctx.n), None, None


def _edge_rows(x, up: int, down: int, group):
    """(rows from the rank above, rows from the rank below) of NHWC `x`:
    the previous rank's last `up` rows and the next rank's first `down`,
    zeros beyond the first and last rank."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    N, h, W, C = x.shape
    mine = torch.cat([x[:, h - up:], x[:, :down]], dim=1)  # what my neighbours read
    got = all_gather(mine, group)
    top = got[me - 1][:, :up] if me > 0 else x.new_zeros((N, up, W, C))
    bottom = got[me + 1][:, up:] if me < n - 1 else x.new_zeros((N, down, W, C))
    return top, bottom


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, up, down, group):
        ctx.up, ctx.down, ctx.group = up, down, group
        top, bottom = _edge_rows(x.detach(), up, down, group)
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    def backward(ctx, g):
        up, down, group = ctx.up, ctx.down, ctx.group
        me, n = dist.get_rank(group), dist.get_world_size(group)
        h = g.shape[1] - up - down
        gx = g[:, up:up + h].clone()
        # my top rows' gradient belongs to the rank above's last rows, my bottom rows' to the first rows below
        sent = torch.cat([g[:, :up], g[:, up + h:]], dim=1).contiguous()
        got = all_gather(sent, group)
        if me < n - 1 and up:
            gx[:, h - up:] += got[me + 1][:, :up]
        if me > 0 and down:
            gx[:, :down] += got[me - 1][:, up:]
        return gx, None, None, None


def copy_in(x, group):
    return _CopyIn.apply(x, group)


def reduce_out(x, group):
    return _ReduceOut.apply(x, group)


def reduce_sum(x, group):
    return _ReduceSum.apply(x, group)


def gather(x, dim: int, group):
    return _Gather.apply(x, dim, group)


def halo(x, up: int, down: int, group):
    """NHWC `x` with `up` rows of the rank above on top and `down` rows of
    the rank below underneath (zeros at the image's edges)."""
    return _Halo.apply(x, up, down, group)
