"""Checkpoint-faithful DDPM/DDIM UNet as plain functions over a param tree.

Port of `attentiondm_tpu/models/unet.py`.  The layout follows the JAX
package so the two compare like with like:

- activations are NHWC tensors;
- params are nested dicts / lists of tensors with the JAX tree's structure
  and names (`down[i].block[j].conv1` ...); conv kernels stay HWIO as stored,
  and `conv2d` is the one place that turns them into torch's OIHW;
- every conv goes through a `conv_apply(name, x, p, stride=, padding=)`
  chokepoint, which calibration intercepts.

Both attention variants are ported: "ddim" (the checkpoints' single-head
block) and "enhanced" (multi-head, per-projection bit-widths, a learnable
gamma residual; `attn_ctx` collects its logit ranges or swaps its core for
the stage-3 mixed-precision one, quant/attention_mp.py).  The forward is
differentiable end to end; with `train=True` it applies the resblocks'
dropout (training.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device
from ..ops.precision import exact_f32  # noqa: F401  re-exported

Params = Any  # nested dict / list tree of tensors


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
    # ADM (models/adm.py): model_type "adm" with guided-diffusion's flags
    model_type: str = "ddpm"
    num_head_channels: int = 64
    learn_sigma: bool = False
    gn_eps: float = 1e-6

    def __repr__(self) -> str:
        """The dataclass's repr, without the ADM fields on a DDPM config: the
        string JAX's `UNetConfig` gives, which calibration caches carry as
        their model signature (quant/calib_cache.py)."""
        adm = ("model_type", "num_head_channels", "learn_sigma", "gn_eps")
        shown = [f.name for f in dataclasses.fields(self) if self.model_type == "adm" or f.name not in adm]
        return f"UNetConfig({', '.join(f'{n}={getattr(self, n)!r}' for n in shown)})"

    @classmethod
    def from_config(cls, config) -> "UNetConfig":
        """Build from a config namespace (`config.load_config`): its `model`
        group, with `attn_resolutions` as a list of resolutions.  A `model.type`
        of "adm" reads guided-diffusion's flags (`num_channels`,
        `channel_mult`, `num_res_blocks`, `attention_resolutions`,
        `num_head_channels`, `use_scale_shift_norm`, `resblock_updown`,
        `learn_sigma`, `dropout`) and takes GroupNorm's eps 1e-5."""
        m, d = config.model, config.data
        if getattr(m, "type", None) == "adm":
            if not (m.use_scale_shift_norm and m.resblock_updown):
                raise NotImplementedError("the port's ADM takes use_scale_shift_norm and resblock_updown True "
                                          "(guided-diffusion's LSUN and ImageNet flags)")
            return cls(in_channels=getattr(m, "in_channels", d.channels),
                       out_ch=d.channels * (2 if m.learn_sigma else 1), ch=m.num_channels,
                       ch_mult=tuple(m.channel_mult), num_res_blocks=m.num_res_blocks,
                       attn_resolutions=tuple(m.attention_resolutions), dropout=m.dropout, resamp_with_conv=True,
                       resolution=d.image_size, model_type="adm", num_head_channels=m.num_head_channels,
                       learn_sigma=bool(m.learn_sigma), gn_eps=1e-5)
        return cls(
            in_channels=m.in_channels,
            out_ch=getattr(m, "out_ch", getattr(m, "out_channels", d.channels)),
            ch=m.ch,
            ch_mult=tuple(m.ch_mult),
            num_res_blocks=m.num_res_blocks,
            attn_resolutions=tuple(m.attn_resolutions),
            dropout=m.dropout,
            resamp_with_conv=getattr(m, "resamp_with_conv", True),
            resolution=d.image_size,
        )

    @property
    def temb_ch(self) -> int:
        return self.ch * 4


def check_ported(cfg: UNetConfig):
    """Raise for a config the port's forward does not cover."""
    if cfg.attn_variant not in ("ddim", "enhanced"):
        raise ValueError(f"attn_variant must be 'ddim' or 'enhanced', got {cfg.attn_variant!r}")
    if cfg.model_type not in ("ddpm", "adm"):
        raise ValueError(f"model_type must be 'ddpm' or 'adm', got {cfg.model_type!r}")
    if cfg.model_type == "adm" and cfg.attn_variant != "ddim":
        raise ValueError("ADM's attention is its own multi-head block: attn_variant stays 'ddim'")


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


def _init_attn(gen, c, variant="ddim"):
    if variant == "enhanced":
        ck = c // 8  # key_channels = in_channels // 8
        return {
            "query_conv": _init_conv(gen, 1, 1, c, ck),
            "key_conv": _init_conv(gen, 1, 1, c, ck),
            "value_conv": _init_conv(gen, 1, 1, c, c),
            "output_conv": _init_conv(gen, 1, 1, c, c),
            "gamma": torch.zeros(1),
            "temperature": torch.ones(1),  # unused, kept for state parity with the reference
        }
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
    if cfg.model_type == "adm":
        from .adm import adm_init

        return map_tree(lambda a: a.to(device), adm_init(gen, cfg, _init_conv, _init_dense, _init_norm))
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
                attns.append(_init_attn(gen, block_in, cfg.attn_variant))
        level: dict = {"block": blocks, "attn": attns}
        if i_level != num_levels - 1:
            level["downsample"] = {"conv": _init_conv(gen, 3, 3, block_in, block_in)} if cfg.resamp_with_conv else {}
            curr_res //= 2
        down.append(level)
    params["down"] = down
    params["mid"] = {
        "block_1": _init_resblock(gen, block_in, block_in, cfg.temb_ch),
        "attn_1": _init_attn(gen, block_in, cfg.attn_variant),
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
                attns.append(_init_attn(gen, block_in, cfg.attn_variant))
        level = {"block": blocks, "attn": attns}
        if i_level != 0:
            level["upsample"] = {"conv": _init_conv(gen, 3, 3, block_in, block_in)} if cfg.resamp_with_conv else {}
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


def from_jax_params(tree, device=None) -> Params:
    """Map the JAX param tree (leaves already numpy, e.g. via `np.asarray`)
    into the port's: same structure and names, HWIO kernels as stored, on
    `device` (None: the package's `default_device()`)."""
    device = default_device() if device is None else device
    return map_tree(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device), tree)


def cast_params(params: Params, dtype) -> Params:
    """Cast every param leaf to `dtype`."""
    return map_tree(lambda a: a.to(dtype), params)


def count_params(params: Params) -> int:
    n = []
    map_tree(lambda a: n.append(a.numel()), params)
    return sum(n)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple tree, in `map_tree`'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure (dicts and lists) holding `leaves` in `tree_leaves` order."""
    it = iter(leaves)
    return map_tree(lambda _: next(it), like)


def lookup(params, name):
    """Param node of a dotted conv name (`down.0.block.1.conv1`)."""
    node = params
    for p in name.split("."):
        node = node[int(p)] if isinstance(node, list) else node[p]
    return node


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _default_conv_apply(name, x, p, *, stride=1, padding="SAME"):
    return conv2d(x, p, stride=stride, padding=padding)


def _norm(x, p, par=None, split=False):
    """GroupNorm under the `parallel=` context: the rows' sums all-reduced
    (sp), or the local groups of a channel-split norm (tp)."""
    if par is None:
        return group_norm(x, p)
    if par.sp:
        return par.group_norm(x, p)
    return group_norm(x, p, num_groups=par.norm_groups(split))


def _col(x, par):
    """A replicated input of a column-parallel layer (tp's f), else x."""
    return x if par is None else par.column_in(x)


def _row(conv_apply, name, h, p, par):
    """A row-parallel conv (tp: partial sums all-reduced, then the bias)."""
    return conv_apply(name, h, p) if par is None else par.row_conv(conv_apply, name, h, p)


def _resblock_apply(name, p, x, temb, conv_apply, dropout=None, gates=None, par=None):
    h = swish(_norm(x, p["norm1"], par))
    h = conv_apply(f"{name}.conv1", _col(h, par), p["conv1"])
    h = h + dense(_col(swish(temb), par), p["temb_proj"])[:, None, None, :]
    h = swish(_norm(h, p["norm2"], par, split=True))
    if dropout is not None:
        h = dropout(h)
    h = _row(conv_apply, f"{name}.conv2", h, p["conv2"], par)
    if "nin_shortcut" in p:
        x = conv_apply(f"{name}.nin_shortcut", x, p["nin_shortcut"])
    if gates is not None and "resblock" in gates:
        h = h * gates["resblock"]
    return x + h


def _attn_apply_ddim(name, p, x, conv_apply, par=None):
    """Single-head attention block: softmax(q k^T / sqrt(C)) v."""
    from ..ops.attention import spatial_attention

    B, H, W, C = x.shape
    h = _col(_norm(x, p["norm"], par), par)
    q = conv_apply(f"{name}.q", h, p["q"]).reshape(B, H * W, -1)
    k = conv_apply(f"{name}.k", h, p["k"]).reshape(B, H * W, -1)
    v = conv_apply(f"{name}.v", h, p["v"]).reshape(B, H * W, -1)
    if par is None:
        h = spatial_attention(q, k, v, scale=C ** -0.5)
    else:
        h = par.attention(q, k.transpose(1, 2), v, C ** -0.5)
    h = _row(conv_apply, f"{name}.proj_out", h.to(x.dtype).reshape(B, H, W, -1), p["proj_out"], par)
    return x + h


def _attn_apply_enhanced(name, p, x, conv_apply, cfg, attn_ctx=None, par=None):
    """The enhanced attention block: 1x1 query / key / value / output
    projections with key_channels = C // 8, softmax(q k^T / sqrt(Ck)) v over
    the whole projection, and `gamma * out + x`.

    `attn_ctx` keys: `collect` (a dict: the block's logit (min, max), 0-d
    tensors, is written under its name), `mp_states` ({name:
    MPAttentionState}: the mixed-precision core replaces the softmax one, at
    `base_bits` (default 8), `timestep` (the diffusion timestep, an integer
    tensor or None) and `head_split` (default "aligned"))."""
    B, H, W, C = x.shape
    xc = _col(x, par)
    q = conv_apply(f"{name}.query_conv", xc, p["query_conv"])
    k = conv_apply(f"{name}.key_conv", xc, p["key_conv"])
    v = conv_apply(f"{name}.value_conv", xc, p["value_conv"])
    Ck = q.shape[-1]
    q = q.reshape(B, H * W, Ck)
    k = k.reshape(B, H * W, Ck).transpose(1, 2)  # [B, Ck, HW]
    v = v.reshape(B, H * W, -1)
    ctx = attn_ctx or {}
    collect = ctx.get("collect")
    if collect is not None:
        lg = torch.matmul(q.float(), k.float()) * (Ck ** -0.5)
        collect[name] = (lg.amin(), lg.amax())
    if par is None:
        out = enhanced_core(name, q, k, v, cfg, ctx).to(x.dtype)
    else:  # the scale is the whole projection's: Ck is a shard's under tp
        out = par.attention(q, k, v, (Ck * (par.size if par.tp else 1)) ** -0.5).to(x.dtype)
    out = _row(conv_apply, f"{name}.output_conv", out.reshape(B, H, W, -1), p["output_conv"], par)
    return p["gamma"].to(x.dtype) * out + x


def enhanced_core(name, q, k, v, cfg, attn_ctx=None):
    """The enhanced block's core on q [B, L, Ck], k [B, Ck, L] and v [B, L,
    C]: softmax(q k / sqrt(Ck)) v, or where `attn_ctx`'s `mp_states` holds
    the block `name`, the stage-3 mixed-precision core (`mp_attention` at the
    context's `base_bits`, `timestep` and `head_split`).  The FP, fake-quant
    and serving forwards all call it.  The products sum in float32 and the
    softmax runs in float32; at a bf16 compute dtype its weights and the
    output round to bf16, as in JAX."""
    ctx = attn_ctx or {}
    mp_state = (ctx.get("mp_states") or {}).get(name)
    if mp_state is not None:
        from ..quant.attention_mp import mp_attention

        return mp_attention(q, k, v, mp_state, num_heads=cfg.attn_heads, base_bits=ctx.get("base_bits", 8),
                            timestep=ctx.get("timestep"), head_split=ctx.get("head_split", "aligned"))
    w = torch.softmax(torch.matmul(q.float(), k.float()) * (q.shape[-1] ** -0.5), dim=-1).to(q.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def _attn_apply(name, p, x, conv_apply, cfg, attn_ctx, gates=None, par=None):
    """The configured attention block; a `gates["attention"]` scales its
    change to x: x + g * (out - x)."""
    if cfg.attn_variant == "enhanced":
        out = _attn_apply_enhanced(name, p, x, conv_apply, cfg, attn_ctx, par)
    else:
        out = _attn_apply_ddim(name, p, x, conv_apply, par)
    if gates is not None and "attention" in gates:
        out = x + gates["attention"] * (out - x)
    return out


def avg_pool2(x):
    """The 2x2 average of NHWC `x` at stride 2, each window summed row by
    row from the top left, ((x00 + x01) + x10) + x11, then divided by 4:
    the order of JAX's `reduce_window` sum."""
    s = x[:, 0::2, 0::2] + x[:, 0::2, 1::2]
    return (s + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) / 4.0


def nearest_up2(x):
    """Nearest-neighbour 2x upsample of NHWC `x`: each pixel repeated 2x2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _downsample(name, p, x, conv_apply, with_conv=True, par=None):
    if not with_conv:
        return avg_pool2(x)
    # asymmetric (0,1,0,1) pad, then a VALID stride-2 conv (the DDPM graph)
    x = par.pad_down(x) if par is not None and par.sp else F.pad(x, (0, 0, 0, 1, 0, 1))
    return conv_apply(f"{name}.conv", x, p["conv"], stride=2, padding="VALID")


def _upsample(name, p, x, conv_apply, with_conv=True):
    x = nearest_up2(x)
    return conv_apply(f"{name}.conv", x, p["conv"]) if with_conv else x


def _dropout(cfg: UNetConfig, train: bool, generator, dropout_masks):
    """The resblocks' dropout, `h -> where(mask, h / keep, 0)` with mask ~
    Bernoulli(keep) (`rand < keep`, drawn from `generator` on h's device, or
    the next of `dropout_masks`), or None where it does not run: it runs
    with `train`, a nonzero `cfg.dropout` and randomness given."""
    if not (train and cfg.dropout > 0 and (generator is not None or dropout_masks is not None)):
        return None
    keep = 1.0 - cfg.dropout
    masks = None if dropout_masks is None else iter(dropout_masks)

    def drop(h):
        if masks is not None:
            mask = next(masks)
        else:
            mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
        return torch.where(mask, h / keep, 0.0)

    return drop


@exact_f32()
def unet_apply(params: Params, cfg: UNetConfig, x: torch.Tensor, t: torch.Tensor, *,
               conv_apply: Callable | None = None, attn_ctx: dict | None = None,
               compute_dtype=None, train: bool = False, generator: torch.Generator | None = None,
               dropout_masks=None, gates: dict | None = None, parallel=None) -> torch.Tensor:
    """Predict eps from (x_t [NHWC], t [N]); float32 out, differentiable in
    params and x.  `attn_ctx` goes to every enhanced attention block
    (`_attn_apply_enhanced`).

    `compute_dtype` (e.g. torch.bfloat16) runs the network at that
    activation dtype: x and the timestep embedding are cast to it, and the
    params must be pre-cast (`cast_params`).  GroupNorm statistics and the
    attention softmax stay float32.

    `train=True` applies dropout (rate `cfg.dropout`) after each resblock's
    second GroupNorm + swish, with masks drawn from `generator` or handed in
    as `dropout_masks` (one bool tensor per resblock, in call order: down,
    mid 1, mid 2, up; JAX draws resblock i's from `split(rng, 64)[i]`).
    Without either, no dropout runs.

    `gates` (0-d tensors under "resblock", "attention", "temb", any of them)
    scale every resblock's residual branch, every attention block's change
    to its input and the timestep embedding before its MLP: the ablation
    search's architecture gates, differentiable through autograd.  Without
    them every output is as it was.

    `parallel` (a `parallel.tp.UNetParallel`) runs the forward on one
    rank's shard: its params split over channels (tp) or x's rows of the
    images (sp), with the collectives where GSPMD puts JAX's; eps comes
    back as this rank's part (sp: its rows).  Under sp the levels from
    `parallel.check_rows(cfg)` on run whole on every rank: the rows are
    gathered before the downsample into the first of them and cut back to
    this rank's after the upsample out of it.  Without it nothing changes.

    An ADM config (`cfg.model_type == "adm"`, models/adm.py) takes
    `conv_apply`, `train` and its dropout; `attn_ctx`, `compute_dtype`,
    `gates` and `parallel` are the DDPM UNet's and raise there."""
    check_ported(cfg)
    if cfg.model_type == "adm":
        if attn_ctx is not None or compute_dtype is not None or gates is not None or parallel is not None:
            raise NotImplementedError("ADM's forward takes conv_apply, train and dropout: no attn_ctx, compute_dtype, "
                                      "gates or parallel")
        from .adm import adm_apply

        return adm_apply(params, cfg, x, t, conv_apply or _default_conv_apply,
                         _dropout(cfg, train, generator, dropout_masks))
    num_levels = len(cfg.ch_mult)
    ca_whole = conv_apply or _default_conv_apply
    ca, par, rep = ca_whole, parallel, num_levels
    if par is not None:
        rep = par.check_rows(cfg)
        ca = par.conv(ca_whole)

    def at(level):
        """(conv_apply, parallel context) of a level: split, or run whole."""
        return (ca, par) if level < rep else (ca_whole, None)

    drop = _dropout(cfg, train, generator, dropout_masks)

    temb = get_timestep_embedding(t, cfg.ch)
    if gates is not None and "temb" in gates:
        temb = temb * gates["temb"]
    if compute_dtype is not None:
        x, temb = x.to(compute_dtype), temb.to(compute_dtype)
    temb = dense(swish(dense(temb, params["temb"]["dense0"])), params["temb"]["dense1"])

    hs = [ca("conv_in", x, params["conv_in"])]
    for i_level in range(num_levels):
        lp = params["down"][i_level]
        ca_l, par_l = at(i_level)
        for i_block in range(cfg.num_res_blocks):
            h = _resblock_apply(f"down.{i_level}.block.{i_block}", lp["block"][i_block], hs[-1], temb, ca_l, drop,
                                gates, par_l)
            if lp["attn"]:
                h = _attn_apply(f"down.{i_level}.attn.{i_block}", lp["attn"][i_block], h, ca_l, cfg, attn_ctx,
                                gates, par_l)
            hs.append(h)
        if i_level != num_levels - 1:
            h = hs[-1]
            if i_level + 1 == rep:  # the next level runs whole: gather the rows, downsample them whole
                h, (ca_l, par_l) = par.gather_rows(h), at(rep)
            hs.append(_downsample(f"down.{i_level}.downsample", lp["downsample"], h, ca_l, cfg.resamp_with_conv,
                                  par_l))

    h = hs[-1]
    ca_l, par_l = at(num_levels - 1)
    h = _resblock_apply("mid.block_1", params["mid"]["block_1"], h, temb, ca_l, drop, gates, par_l)
    h = _attn_apply("mid.attn_1", params["mid"]["attn_1"], h, ca_l, cfg, attn_ctx, gates, par_l)
    h = _resblock_apply("mid.block_2", params["mid"]["block_2"], h, temb, ca_l, drop, gates, par_l)

    for i_level in reversed(range(num_levels)):
        lp = params["up"][i_level]
        ca_l, par_l = at(i_level)
        for i_block in range(cfg.num_res_blocks + 1):
            h = _resblock_apply(f"up.{i_level}.block.{i_block}", lp["block"][i_block],
                                torch.cat([h, hs.pop()], dim=-1), temb, ca_l, drop, gates, par_l)
            if lp["attn"]:
                h = _attn_apply(f"up.{i_level}.attn.{i_block}", lp["attn"][i_block], h, ca_l, cfg, attn_ctx,
                                gates, par_l)
        if i_level != 0:
            h = _upsample(f"up.{i_level}.upsample", lp["upsample"], h, ca_l, cfg.resamp_with_conv)
            if i_level == rep:  # back to the split levels: this rank's rows
                h = par.local_rows(h)
    assert not hs

    h = swish(_norm(h, params["norm_out"], par))
    h = ca("conv_out", h, params["conv_out"])
    return h.to(torch.float32)


def dropout_shapes(cfg: UNetConfig, n: int) -> list:
    """The [N, H, W, C] of each resblock's dropout mask at batch `n`, in
    `unet_apply`'s call order (down, mid 1, mid 2, up): `dropout_masks`'s shapes."""
    shapes, res = [], cfg.resolution
    for i, m in enumerate(cfg.ch_mult):
        shapes += [(n, res, res, cfg.ch * m)] * cfg.num_res_blocks
        if i != len(cfg.ch_mult) - 1:
            res //= 2
    shapes += [(n, res, res, cfg.ch * cfg.ch_mult[-1])] * 2
    for i in reversed(range(len(cfg.ch_mult))):
        shapes += [(n, res, res, cfg.ch * cfg.ch_mult[i])] * (cfg.num_res_blocks + 1)
        if i != 0:
            res *= 2
    return shapes


# the 1x1 projections of an attention block, in call order
ATTN_PROJS = {"ddim": ("q", "k", "v", "proj_out"),
              "enhanced": ("query_conv", "key_conv", "value_conv", "output_conv")}


def iter_conv_layers(cfg: UNetConfig):
    """Yield (name, in_channels, kernel_size) for every conv the forward routes
    through `conv_apply`, in call order (lockstep with `unet_apply`)."""
    if cfg.model_type == "adm":
        from .adm import adm_conv_layers

        yield from adm_conv_layers(cfg)
        return
    num_levels = len(cfg.ch_mult)
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    curr_res = cfg.resolution
    projs = ATTN_PROJS[cfg.attn_variant]

    def attn_projs(prefix, c):
        for proj in projs:
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
