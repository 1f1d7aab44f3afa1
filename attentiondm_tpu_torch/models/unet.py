"""Checkpoint-faithful DDPM/DDIM UNet as plain functions over a param tree.

Port of `attentiondm_tpu/models/unet.py`.  The layout follows the JAX
package so the two compare like with like:

- activations are NHWC tensors;
- params are nested dicts / lists of tensors with the JAX tree's structure
  and names (`down[i].block[j].conv1` ...); conv kernels stay HWIO as stored,
  and `conv2d` is the one place that turns them into torch's OIHW;
- every conv goes through a `conv_apply(name, x, p, stride=, padding=)`
  chokepoint, which calibration intercepts.

Only the "ddim" attention variant at inference is ported; the "enhanced"
variant is a later slice (ROADMAP Queue 1) and raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

Params = Any  # nested dict / list tree of tensors


@contextlib.contextmanager
def exact_f32():
    """Full-precision float32 products on the GPU, for the duration of a
    call (a context manager, or a decorator as `@exact_f32()`).

    cuDNN runs float32 convolutions in TF32 by default; the calibration
    ranges are read off these float32 activations, so both TF32 switches are
    off while the port runs float32 math, and restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: tuple = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    dropout: float = 0.1
    resamp_with_conv: bool = True
    resolution: int = 32
    attn_variant: str = "ddim"
    attn_heads: int = 8

    @property
    def temb_ch(self) -> int:
        return self.ch * 4


def _check_variant(cfg: UNetConfig):
    if cfg.attn_variant != "ddim":
        raise NotImplementedError(
            f"attn_variant={cfg.attn_variant!r}: the enhanced attention variant is ported in a "
            "later slice (ROADMAP Queue 1, 'the enhanced variant and the remaining serving flags')"
        )


def check_ported(cfg: UNetConfig):
    """Raise for a config the port's forward does not cover."""
    _check_variant(cfg)
    if not cfg.resamp_with_conv:
        raise NotImplementedError("resamp_with_conv=False is not on the ported path")


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (half sin / half cos)."""
    assert timesteps.ndim == 1
    half_dim = embedding_dim // 2
    emb = math.log(10000) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def swish(x):
    return x * torch.sigmoid(x)


def conv2d(x, p, *, stride: int = 1, padding="SAME"):
    """NHWC conv with an HWIO kernel (converted to OIHW here, nowhere else)."""
    k = p["kernel"]
    kh = k.shape[0]
    if padding == "SAME":
        if stride != 1:
            raise NotImplementedError("SAME padding is only used at stride 1")
        pad = kh // 2
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(padding)
    out = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1) + p["bias"]


def dense(x, p):
    return x @ p["kernel"] + p["bias"]


def group_norm(x, p, num_groups: int = 32, eps: float = 1e-6):
    """GroupNorm over channel-last tensors; statistics in float32, output in
    the input dtype (matches the JAX `group_norm`)."""
    dtype = x.dtype
    N, C = x.shape[0], x.shape[-1]
    g = min(num_groups, C)
    xg = x.to(torch.float32).reshape(N, -1, g, C // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), correction=0, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    x = xg.reshape(x.shape)
    return (x * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# parameter initialization
# ---------------------------------------------------------------------------


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def _init_conv(gen, kh, kw, cin, cout):
    """Torch default Conv2d init, U(+-1/sqrt(fan_in)), HWIO."""
    bound = 1.0 / math.sqrt(kh * kw * cin)
    return {"kernel": _uniform(gen, (kh, kw, cin, cout), bound), "bias": _uniform(gen, (cout,), bound)}


def _init_dense(gen, cin, cout):
    bound = 1.0 / math.sqrt(cin)
    return {"kernel": _uniform(gen, (cin, cout), bound), "bias": _uniform(gen, (cout,), bound)}


def _init_norm(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _init_resblock(gen, cin, cout, temb_ch):
    p = {
        "norm1": _init_norm(cin),
        "conv1": _init_conv(gen, 3, 3, cin, cout),
        "temb_proj": _init_dense(gen, temb_ch, cout),
        "norm2": _init_norm(cout),
        "conv2": _init_conv(gen, 3, 3, cout, cout),
    }
    if cin != cout:
        p["nin_shortcut"] = _init_conv(gen, 1, 1, cin, cout)
    return p


def _init_attn(gen, c):
    return {
        "norm": _init_norm(c),
        "q": _init_conv(gen, 1, 1, c, c),
        "k": _init_conv(gen, 1, 1, c, c),
        "v": _init_conv(gen, 1, 1, c, c),
        "proj_out": _init_conv(gen, 1, 1, c, c),
    }


def unet_init(gen: torch.Generator, cfg: UNetConfig, device) -> Params:
    """Random params with the JAX init's structure and distributions (not its
    numbers), drawn on the CPU from `gen` and moved to `device`."""
    check_ported(cfg)
    num_levels = len(cfg.ch_mult)
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    params: dict = {
        "temb": {
            "dense0": _init_dense(gen, cfg.ch, cfg.temb_ch),
            "dense1": _init_dense(gen, cfg.temb_ch, cfg.temb_ch),
        },
        "conv_in": _init_conv(gen, 3, 3, cfg.in_channels, cfg.ch),
    }
    curr_res = cfg.resolution
    down = []
    block_in = cfg.ch
    for i_level in range(num_levels):
        blocks, attns = [], []
        block_in = cfg.ch * in_ch_mult[i_level]
        block_out = cfg.ch * cfg.ch_mult[i_level]
        for _ in range(cfg.num_res_blocks):
            blocks.append(_init_resblock(gen, block_in, block_out, cfg.temb_ch))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                attns.append(_init_attn(gen, block_in))
        level: dict = {"block": blocks, "attn": attns}
        if i_level != num_levels - 1:
            level["downsample"] = {"conv": _init_conv(gen, 3, 3, block_in, block_in)}
            curr_res //= 2
        down.append(level)
    params["down"] = down
    params["mid"] = {
        "block_1": _init_resblock(gen, block_in, block_in, cfg.temb_ch),
        "attn_1": _init_attn(gen, block_in),
        "block_2": _init_resblock(gen, block_in, block_in, cfg.temb_ch),
    }
    up = [None] * num_levels
    for i_level in reversed(range(num_levels)):
        blocks, attns = [], []
        block_out = cfg.ch * cfg.ch_mult[i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            skip_in = cfg.ch * cfg.ch_mult[i_level]
            if i_block == cfg.num_res_blocks:
                skip_in = cfg.ch * in_ch_mult[i_level]
            blocks.append(_init_resblock(gen, block_in + skip_in, block_out, cfg.temb_ch))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                attns.append(_init_attn(gen, block_in))
        level = {"block": blocks, "attn": attns}
        if i_level != 0:
            level["upsample"] = {"conv": _init_conv(gen, 3, 3, block_in, block_in)}
            curr_res *= 2
        up[i_level] = level
    params["up"] = up
    params["norm_out"] = _init_norm(block_in)
    params["conv_out"] = _init_conv(gen, 3, 3, block_in, cfg.out_ch)
    return map_tree(lambda a: a.to(device), params)


def map_tree(fn, tree):
    """Apply `fn` to every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def from_jax_params(tree, device="cpu") -> Params:
    """Map the JAX param tree (leaves already numpy, e.g. via `np.asarray`)
    into the port's: same structure and names, HWIO kernels as stored."""
    return map_tree(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device), tree)


def count_params(params: Params) -> int:
    n = []
    map_tree(lambda a: n.append(a.numel()), params)
    return sum(n)


def lookup(params, name):
    """Param node of a dotted conv name (`down.0.block.1.conv1`)."""
    node = params
    for p in name.split("."):
        node = node[int(p)] if isinstance(node, list) else node[p]
    return node


# ---------------------------------------------------------------------------
# forward (inference)
# ---------------------------------------------------------------------------


def _default_conv_apply(name, x, p, *, stride=1, padding="SAME"):
    return conv2d(x, p, stride=stride, padding=padding)


def _resblock_apply(name, p, x, temb, conv_apply):
    h = swish(group_norm(x, p["norm1"]))
    h = conv_apply(f"{name}.conv1", h, p["conv1"])
    h = h + dense(swish(temb), p["temb_proj"])[:, None, None, :]
    h = swish(group_norm(h, p["norm2"]))
    h = conv_apply(f"{name}.conv2", h, p["conv2"])
    if "nin_shortcut" in p:
        x = conv_apply(f"{name}.nin_shortcut", x, p["nin_shortcut"])
    return x + h


def _attn_apply_ddim(name, p, x, conv_apply):
    """Single-head attention block: softmax(q k^T / sqrt(C)) v."""
    from ..ops.attention import spatial_attention

    B, H, W, C = x.shape
    h = group_norm(x, p["norm"])
    q = conv_apply(f"{name}.q", h, p["q"]).reshape(B, H * W, C)
    k = conv_apply(f"{name}.k", h, p["k"]).reshape(B, H * W, C)
    v = conv_apply(f"{name}.v", h, p["v"]).reshape(B, H * W, C)
    h = spatial_attention(q, k, v, scale=C ** -0.5).to(x.dtype).reshape(B, H, W, C)
    h = conv_apply(f"{name}.proj_out", h, p["proj_out"])
    return x + h


def _downsample(name, p, x, conv_apply):
    # asymmetric (0,1,0,1) pad, then a VALID stride-2 conv (the DDPM graph)
    x = F.pad(x, (0, 0, 0, 1, 0, 1))
    return conv_apply(f"{name}.conv", x, p["conv"], stride=2, padding="VALID")


def _upsample(name, p, x, conv_apply):
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # nearest 2x
    return conv_apply(f"{name}.conv", x, p["conv"])


@exact_f32()
def unet_apply(params: Params, cfg: UNetConfig, x: torch.Tensor, t: torch.Tensor, *,
               conv_apply: Callable | None = None) -> torch.Tensor:
    """Predict eps from (x_t [NHWC], t [N]); float32 out, inference only."""
    check_ported(cfg)
    ca = conv_apply or _default_conv_apply
    num_levels = len(cfg.ch_mult)

    temb = get_timestep_embedding(t, cfg.ch)
    temb = dense(swish(dense(temb, params["temb"]["dense0"])), params["temb"]["dense1"])

    hs = [ca("conv_in", x, params["conv_in"])]
    for i_level in range(num_levels):
        lp = params["down"][i_level]
        for i_block in range(cfg.num_res_blocks):
            h = _resblock_apply(f"down.{i_level}.block.{i_block}", lp["block"][i_block], hs[-1], temb, ca)
            if lp["attn"]:
                h = _attn_apply_ddim(f"down.{i_level}.attn.{i_block}", lp["attn"][i_block], h, ca)
            hs.append(h)
        if i_level != num_levels - 1:
            hs.append(_downsample(f"down.{i_level}.downsample", lp["downsample"], hs[-1], ca))

    h = hs[-1]
    h = _resblock_apply("mid.block_1", params["mid"]["block_1"], h, temb, ca)
    h = _attn_apply_ddim("mid.attn_1", params["mid"]["attn_1"], h, ca)
    h = _resblock_apply("mid.block_2", params["mid"]["block_2"], h, temb, ca)

    for i_level in reversed(range(num_levels)):
        lp = params["up"][i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            h = _resblock_apply(f"up.{i_level}.block.{i_block}", lp["block"][i_block],
                                torch.cat([h, hs.pop()], dim=-1), temb, ca)
            if lp["attn"]:
                h = _attn_apply_ddim(f"up.{i_level}.attn.{i_block}", lp["attn"][i_block], h, ca)
        if i_level != 0:
            h = _upsample(f"up.{i_level}.upsample", lp["upsample"], h, ca)
    assert not hs

    h = swish(group_norm(h, params["norm_out"]))
    h = ca("conv_out", h, params["conv_out"])
    return h.to(torch.float32)


def iter_conv_layers(cfg: UNetConfig):
    """Yield (name, in_channels, kernel_size) for every conv the forward routes
    through `conv_apply`, in call order (lockstep with `unet_apply`)."""
    _check_variant(cfg)
    num_levels = len(cfg.ch_mult)
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    curr_res = cfg.resolution

    def attn_projs(prefix, c):
        for proj in ("q", "k", "v", "proj_out"):
            yield (f"{prefix}.{proj}", c, 1)

    yield ("conv_in", cfg.in_channels, 3)
    block_in = cfg.ch
    for i_level in range(num_levels):
        block_in = cfg.ch * in_ch_mult[i_level]
        block_out = cfg.ch * cfg.ch_mult[i_level]
        for i_block in range(cfg.num_res_blocks):
            yield (f"down.{i_level}.block.{i_block}.conv1", block_in, 3)
            yield (f"down.{i_level}.block.{i_block}.conv2", block_out, 3)
            if block_in != block_out:
                yield (f"down.{i_level}.block.{i_block}.nin_shortcut", block_in, 1)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                yield from attn_projs(f"down.{i_level}.attn.{i_block}", block_in)
        if i_level != num_levels - 1:
            if cfg.resamp_with_conv:
                yield (f"down.{i_level}.downsample.conv", block_in, 3)
            curr_res //= 2

    yield ("mid.block_1.conv1", block_in, 3)
    yield ("mid.block_1.conv2", block_in, 3)
    yield from attn_projs("mid.attn_1", block_in)
    yield ("mid.block_2.conv1", block_in, 3)
    yield ("mid.block_2.conv2", block_in, 3)

    for i_level in reversed(range(num_levels)):
        block_out = cfg.ch * cfg.ch_mult[i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            skip_in = cfg.ch * cfg.ch_mult[i_level]
            if i_block == cfg.num_res_blocks:
                skip_in = cfg.ch * in_ch_mult[i_level]
            yield (f"up.{i_level}.block.{i_block}.conv1", block_in + skip_in, 3)
            yield (f"up.{i_level}.block.{i_block}.conv2", block_out, 3)
            if block_in + skip_in != block_out:
                yield (f"up.{i_level}.block.{i_block}.nin_shortcut", block_in + skip_in, 1)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                yield from attn_projs(f"up.{i_level}.attn.{i_block}", block_in)
        if i_level != 0:
            if cfg.resamp_with_conv:
                yield (f"up.{i_level}.upsample.conv", block_in, 3)
            curr_res *= 2

    yield ("conv_out", block_in, 3)
