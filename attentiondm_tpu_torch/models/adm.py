"""ADM's UNet (Dhariwal & Nichol 2021, arXiv:2105.05233; openai/guided-diffusion
`guided_diffusion/unet.py` `UNetModel`) as plain functions over a param tree,
beside the DDPM UNet of `unet.py`.

The tree keeps the DDPM tree's layout and names, so that calibration,
the fold and the serving path find every conv by the same dotted names:
`temb.dense0` / `dense1` (`time_embed.0` / `.2`), `conv_in`,
`down[i].block[j]` and `down[i].attn[j]`, `down[i].downsample` (a resblock
that pools), `mid.block_1` / `attn_1` / `block_2`, `up[i].block[j]`,
`up[i].attn[j]`, `up[i].upsample` (a resblock that upsamples), `norm_out`,
`conv_out`.  A resblock holds `norm1`, `conv1`, `temb_proj` (`emb_layers.1`,
to 2 * C_out: scale then shift), `norm2`, `conv2` and, where the channels
change, the 1x1 `nin_shortcut` (`skip_connection`).  An attention block
holds `norm` and q, k, v and proj_out as separate 1x1 kernels: the checkpoint's
one `qkv` conv split in its legacy head-interleaved order
(`from_guided_diffusion`).

Where ADM's float forward differs from the DDPM's:
  - the timestep embedding is [cos, sin] at frequencies exp(-ln(1e4) i / half);
  - a resblock projects the embedding to (scale, shift) and computes
    GN(h) * (1 + scale) + shift after conv1, with no add before the norm;
  - the resampling resblocks pool (2x2 average) or upsample (nearest x2) both
    the normalized, activated input of conv1 and the skip path;
  - attention runs in heads of `num_head_channels` at scale d^-1/2;
  - GroupNorm's eps is 1e-5 (`UNetConfig.gn_eps`);
  - with `learn_sigma` the output has twice the image's channels, eps first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def adm_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """guided-diffusion's `timestep_embedding`: [cos, sin] of t * exp(-ln(1e4) * i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def heads_of(cfg, channels: int) -> int:
    """The attention heads of a block of `channels`: channels / num_head_channels."""
    if channels % cfg.num_head_channels:
        raise ValueError(f"ADM attention: {channels} channels are not whole heads of {cfg.num_head_channels}")
    return channels // cfg.num_head_channels


def adm_blocks(cfg) -> list:
    """Every resblock and attention block of the forward, in order, as
    (kind, name, H, cin, cout, resample): kind "res" or "attn", H the block's
    input resolution, cin its input channels (a decoder block's concat
    included), resample None, "down" or "up"."""
    ch, mult, nrb = cfg.ch, tuple(cfg.ch_mult), cfg.num_res_blocks
    res, c, skips, out = cfg.resolution, ch, [ch], []
    for i, m in enumerate(mult):
        for j in range(nrb):
            out.append(("res", f"down.{i}.block.{j}", res, c, ch * m, None))
            c = ch * m
            if res in cfg.attn_resolutions:
                out.append(("attn", f"down.{i}.attn.{j}", res, c, c, None))
            skips.append(c)
        if i != len(mult) - 1:
            out.append(("res", f"down.{i}.downsample", res, c, c, "down"))
            res //= 2
            skips.append(c)
    out += [("res", "mid.block_1", res, c, c, None), ("attn", "mid.attn_1", res, c, c, None),
            ("res", "mid.block_2", res, c, c, None)]
    for i in reversed(range(len(mult))):
        for j in range(nrb + 1):
            cin = c + skips.pop()
            c = ch * mult[i]
            out.append(("res", f"up.{i}.block.{j}", res, cin, c, None))
            if res in cfg.attn_resolutions:
                out.append(("attn", f"up.{i}.attn.{j}", res, c, c, None))
        if i != 0:
            out.append(("res", f"up.{i}.upsample", res, c, c, "up"))
            res *= 2
    return out


def adm_conv_layers(cfg):
    """(name, in_channels, kernel_size) of every conv of the forward, in call order."""
    yield ("conv_in", cfg.in_channels, 3)
    for kind, name, _H, cin, cout, _rs in adm_blocks(cfg):
        if kind == "attn":
            for proj in ("q", "k", "v", "proj_out"):
                yield (f"{name}.{proj}", cin, 1)
            continue
        yield (f"{name}.conv1", cin, 3)
        yield (f"{name}.conv2", cout, 3)
        if cin != cout:
            yield (f"{name}.nin_shortcut", cin, 1)
    yield ("conv_out", cfg.ch * cfg.ch_mult[0], 3)


def _set(tree, name, value):
    parts = name.split(".")
    for p in parts[:-1]:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    if isinstance(tree, list):
        tree[int(parts[-1])] = value
    else:
        tree[parts[-1]] = value


def adm_skeleton(cfg) -> dict:
    """The tree's containers: the DDPM tree's levels with empty lists."""
    levels = len(cfg.ch_mult)
    return {"temb": {}, "down": [{"block": [None] * cfg.num_res_blocks,
                                  "attn": [None] * (cfg.num_res_blocks if cfg.resolution >> i in cfg.attn_resolutions
                                                    else 0)} for i in range(levels)],
            "mid": {}, "up": [{"block": [None] * (cfg.num_res_blocks + 1),
                               "attn": [None] * ((cfg.num_res_blocks + 1) if cfg.resolution >> i in cfg.attn_resolutions
                                                 else 0)} for i in range(levels)]}


def adm_init(gen, cfg, init_conv, init_dense, init_norm) -> dict:
    """Random params of `cfg` in the tree's layout, drawn by the DDPM init's
    helpers (torch's default layer init; guided-diffusion's zero-initialized
    output convs are drawn like the others)."""
    tree = adm_skeleton(cfg)
    temb_ch = cfg.temb_ch
    tree["temb"] = {"dense0": init_dense(gen, cfg.ch, temb_ch), "dense1": init_dense(gen, temb_ch, temb_ch)}
    tree["conv_in"] = init_conv(gen, 3, 3, cfg.in_channels, cfg.ch)
    for kind, name, _H, cin, cout, _rs in adm_blocks(cfg):
        if kind == "attn":
            node = {"norm": init_norm(cin)}
            node.update({k: init_conv(gen, 1, 1, cin, cin) for k in ("q", "k", "v", "proj_out")})
        else:
            node = {"norm1": init_norm(cin), "conv1": init_conv(gen, 3, 3, cin, cout),
                    "temb_proj": init_dense(gen, temb_ch, 2 * cout), "norm2": init_norm(cout),
                    "conv2": init_conv(gen, 3, 3, cout, cout)}
            if cin != cout:
                node["nin_shortcut"] = init_conv(gen, 1, 1, cin, cout)
        _set(tree, name, node)
    tree["norm_out"] = init_norm(cfg.ch * cfg.ch_mult[0])
    tree["conv_out"] = init_conv(gen, 3, 3, cfg.ch * cfg.ch_mult[0], cfg.out_ch)
    return tree


def scale_shift(emb_out: torch.Tensor):
    """(1 + scale, shift) of a resblock's embedding projection [N, 2 C]."""
    scale, shift = emb_out.chunk(2, dim=-1)
    return 1.0 + scale, shift


def dense_head_attention(q, k, v, heads: int, scale: float):
    """The per-head softmax of `ops.attention.head_attention`, dense and in
    plain torch, with autograd's backward: the core of ADM's float forward
    where gradients are wanted (stage 2 / 3's refinement through the float
    UNet).  K11 has no backward, so gradients never run through it."""
    B, L, C = q.shape
    qh, kh, vh = (a.to(torch.float32).reshape(B, L, heads, C // heads) for a in (q, k, v))
    w = torch.softmax(torch.einsum("blhd,bmhd->bhlm", qh, kh) * scale, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", w, vh).reshape(B, L, C).to(q.dtype)


def adm_apply(params, cfg, x, t, conv_apply, dropout=None, plain: bool = False):
    """eps (and with `learn_sigma` the variance's channels after it) of ADM's
    float UNet at (x [N, H, W, C], t [N]); every conv through `conv_apply`."""
    from ..ops.attention import head_attention
    from .unet import avg_pool2, dense, group_norm, lookup, nearest_up2, swish

    eps = cfg.gn_eps
    emb = adm_timestep_embedding(t, cfg.ch)
    emb = dense(swish(dense(emb, params["temb"]["dense0"])), params["temb"]["dense1"])

    def resblock(name, p, h_in, resample):
        h = swish(group_norm(h_in, p["norm1"], eps=eps))
        if resample == "down":
            h, h_in = avg_pool2(h), avg_pool2(h_in)
        elif resample == "up":
            h, h_in = nearest_up2(h), nearest_up2(h_in)
        h = conv_apply(f"{name}.conv1", h, p["conv1"])
        gain, shift = scale_shift(dense(swish(emb), p["temb_proj"]))
        h = swish(group_norm(h, p["norm2"], eps=eps) * gain[:, None, None, :] + shift[:, None, None, :])
        if dropout is not None:
            h = dropout(h)
        h = conv_apply(f"{name}.conv2", h, p["conv2"])
        if "nin_shortcut" in p:
            h_in = conv_apply(f"{name}.nin_shortcut", h_in, p["nin_shortcut"])
        return h_in + h

    def attn(name, p, h_in):
        B, H, W, C = h_in.shape
        h = group_norm(h_in, p["norm"], eps=eps)
        q, k, v = (conv_apply(f"{name}.{s}", h, p[s]).reshape(B, H * W, C) for s in ("q", "k", "v"))
        heads, scale = heads_of(cfg, C), cfg.num_head_channels ** -0.5
        if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
            o = dense_head_attention(q, k, v, heads, scale)
        else:
            o = head_attention(q, k, v, heads, scale=scale, plain=plain)
        return h_in + conv_apply(f"{name}.proj_out", o.reshape(B, H, W, C), p["proj_out"])

    h = conv_apply("conv_in", x, params["conv_in"])
    hs = [h]
    for kind, name, _H, _cin, _cout, rs in adm_blocks(cfg):
        part, p = name.split(".")[0], lookup(params, name)
        if kind == "attn":
            h = attn(name, p, h)
            if part == "down":
                hs[-1] = h
            continue
        if part == "up" and rs is None:
            h = torch.cat([h, hs.pop()], dim=-1)
        h = resblock(name, p, h, rs)
        if part == "down":
            hs.append(h)
    assert not hs
    h = swish(group_norm(h, params["norm_out"], eps=eps))
    return conv_apply("conv_out", h, params["conv_out"]).to(torch.float32)


# ---------------------------------------------------------------------------
# guided-diffusion's state dict
# ---------------------------------------------------------------------------


def _gd_names(cfg) -> list:
    """(guided-diffusion module prefix, the port's block name) of every block."""
    out, n_in, n_out, in_up = [], 1, 0, False
    last = None
    for kind, name, _H, _cin, _cout, rs in adm_blocks(cfg):
        part = name.split(".")[0]
        if part == "down":
            if kind == "res":
                out.append((f"input_blocks.{n_in}.0", name))
                n_in += 1
            else:
                out.append((f"input_blocks.{n_in - 1}.1", name))
        elif part == "mid":
            out.append((f"middle_block.{('block_1', 'attn_1', 'block_2').index(name.split('.')[1])}", name))
        else:
            if kind == "res" and rs is None:
                if in_up:
                    n_out += 1
                out.append((f"output_blocks.{n_out}.0", name))
                last, in_up = 1, True
            else:
                out.append((f"output_blocks.{n_out}.{last}", name))
                last += 1
    return out


def _conv_hwio(w):
    return (w[..., None] if w.ndim == 3 else w).permute(2, 3, 1, 0).contiguous()


def split_legacy_qkv(w: torch.Tensor, b: torch.Tensor, heads: int):
    """guided-diffusion's `qkv` conv (weight [3C, C(, 1)], bias [3C]) in
    `QKVAttentionLegacy`'s order -> (q, k, v) as (weight [C, C], bias [C]):
    of head h's outputs [3 d h, 3 d (h + 1)), the first d are its queries,
    the next d its keys, the last d its values."""
    C3 = w.shape[0]
    C, d = C3 // 3, C3 // 3 // heads
    w = w.reshape(heads, 3, d, -1)
    b = b.reshape(heads, 3, d)
    return [(w[:, i].reshape(C, -1), b[:, i].reshape(C)) for i in range(3)]


def from_guided_diffusion(state_dict, cfg, device="cpu") -> dict:
    """A guided-diffusion `UNetModel` state dict -> the port's tree, strict
    both ways (every unmapped and every missing key is named): conv OIHW ->
    HWIO, Linear [out, in] -> [in, out], `qkv` split per head."""
    sd = {k: torch.as_tensor(v).to(torch.float32) for k, v in state_dict.items()}
    used = set()

    def take(key):
        if key not in sd:
            raise KeyError(f"from_guided_diffusion: missing {key}")
        used.add(key)
        return sd[key]

    def conv(prefix):
        return {"kernel": _conv_hwio(take(f"{prefix}.weight")), "bias": take(f"{prefix}.bias")}

    def lin(prefix):
        return {"kernel": take(f"{prefix}.weight").t().contiguous(), "bias": take(f"{prefix}.bias")}

    def norm(prefix):
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    tree = adm_skeleton(cfg)
    tree["temb"] = {"dense0": lin("time_embed.0"), "dense1": lin("time_embed.2")}
    tree["conv_in"] = conv("input_blocks.0.0")
    kinds = {name: (kind, cin) for kind, name, _H, cin, _co, _rs in adm_blocks(cfg)}
    for prefix, name in _gd_names(cfg):
        kind, cin = kinds[name]
        if kind == "attn":
            node = {"norm": norm(f"{prefix}.norm")}
            qkv = split_legacy_qkv(take(f"{prefix}.qkv.weight"), take(f"{prefix}.qkv.bias"), heads_of(cfg, cin))
            for key, (w, b) in zip(("q", "k", "v"), qkv):
                node[key] = {"kernel": _conv_hwio(w[..., None, None]), "bias": b.contiguous()}
            node["proj_out"] = conv(f"{prefix}.proj_out")
        else:
            node = {"norm1": norm(f"{prefix}.in_layers.0"), "conv1": conv(f"{prefix}.in_layers.2"),
                    "temb_proj": lin(f"{prefix}.emb_layers.1"), "norm2": norm(f"{prefix}.out_layers.0"),
                    "conv2": conv(f"{prefix}.out_layers.3")}
            if f"{prefix}.skip_connection.weight" in sd:
                node["nin_shortcut"] = conv(f"{prefix}.skip_connection")
        _set(tree, name, node)
    tree["norm_out"] = norm("out.0")
    tree["conv_out"] = conv("out.2")
    extra = sorted(set(sd) - used)
    if extra:
        raise KeyError(f"from_guided_diffusion: unmapped keys {extra[:8]}{' ...' if len(extra) > 8 else ''}")

    def to(t):
        return t.to(device) if torch.is_tensor(t) else {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
            else [to(v) for v in t]

    return to(tree)
