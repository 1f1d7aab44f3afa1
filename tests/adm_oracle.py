"""ADM's float32 UNet as a plain `torch.nn` module, the oracle of the port's
ADM forward (models/adm.py) in the CPU tests.

Written from the published description of guided-diffusion's
`guided_diffusion/unet.py` (openai/guided-diffusion; Dhariwal & Nichol 2021,
arXiv:2105.05233), with its module tree and state-dict names: `time_embed`,
`input_blocks`, `middle_block`, `output_blocks`, `out`; a `ResBlock`'s
`in_layers` (GroupNorm32, SiLU, conv), `emb_layers` (SiLU, Linear to 2 C_out
under `use_scale_shift_norm`), `out_layers` (GroupNorm32, SiLU, Dropout,
conv) and `skip_connection`; an `AttentionBlock`'s `norm`, `qkv` (a 1-D 1x1
conv to 3 C) and `proj_out` around `QKVAttentionLegacy`.  NCHW, as there.
It imports nothing of the port, of JAX or of the JAX package.

Departures from the published code, none of which changes the function:
  - only the configurations the port serves: `use_scale_shift_norm` and
    `resblock_updown` on, no class labels, no checkpointing, float32 only
    (no fp16 conversion);
  - the output convs and `proj_out` are not zero-initialized (the tests load
    seeded random weights into every parameter);
  - `Upsample` / `Downsample` inside the resampling resblocks are written
    inline (`F.interpolate(nearest)` / `F.avg_pool2d(2)`), the modules that
    carry no parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_embedding(timesteps, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(start=0, end=half, dtype=torch.float32) / half)
    args = timesteps[:, None].float() * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


class GroupNorm32(nn.GroupNorm):
    def forward(self, x):
        return super().forward(x.float()).type(x.dtype)


def normalization(channels):
    return GroupNorm32(32, channels)


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, dropout, out_channels=None, up=False, down=False):
        super().__init__()
        self.out_channels = out_channels or channels
        self.in_layers = nn.Sequential(normalization(channels), nn.SiLU(),
                                       nn.Conv2d(channels, self.out_channels, 3, padding=1))
        self.updown = up or down
        self.up, self.down = up, down
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, 2 * self.out_channels))
        self.out_layers = nn.Sequential(normalization(self.out_channels), nn.SiLU(), nn.Dropout(p=dropout),
                                        nn.Conv2d(self.out_channels, self.out_channels, 3, padding=1))
        if self.out_channels == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = nn.Conv2d(channels, self.out_channels, 1)

    def _resample(self, x):
        if self.up:
            return F.interpolate(x, scale_factor=2, mode="nearest")
        return F.avg_pool2d(x, kernel_size=2, stride=2)

    def forward(self, x, emb):
        if self.updown:
            in_rest, in_conv = self.in_layers[:-1], self.in_layers[-1]
            h = in_rest(x)
            h = self._resample(h)
            x = self._resample(x)
            h = in_conv(h)
        else:
            h = self.in_layers(x)
        emb_out = self.emb_layers(emb).type(h.dtype)
        while len(emb_out.shape) < len(h.shape):
            emb_out = emb_out[..., None]
        out_norm, out_rest = self.out_layers[0], self.out_layers[1:]
        scale, shift = torch.chunk(emb_out, 2, dim=1)
        h = out_norm(h) * (1 + scale) + shift
        h = out_rest(h)
        return self.skip_connection(x) + h


class QKVAttentionLegacy(nn.Module):
    def __init__(self, n_heads):
        super().__init__()
        self.n_heads = n_heads

    def forward(self, qkv):
        bs, width, length = qkv.shape
        ch = width // (3 * self.n_heads)
        q, k, v = qkv.reshape(bs * self.n_heads, ch * 3, length).split(ch, dim=1)
        scale = 1 / math.sqrt(math.sqrt(ch))
        weight = torch.einsum("bct,bcs->bts", q * scale, k * scale)
        weight = torch.softmax(weight.float(), dim=-1).type(weight.dtype)
        a = torch.einsum("bts,bcs->bct", weight, v)
        return a.reshape(bs, -1, length)


class AttentionBlock(nn.Module):
    def __init__(self, channels, num_head_channels):
        super().__init__()
        self.num_heads = channels // num_head_channels
        self.norm = normalization(channels)
        self.qkv = nn.Conv1d(channels, channels * 3, 1)
        self.attention = QKVAttentionLegacy(self.num_heads)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        b, c, *spatial = x.shape
        x = x.reshape(b, c, -1)
        qkv = self.qkv(self.norm(x))
        h = self.attention(qkv)
        h = self.proj_out(h)
        return (x + h).reshape(b, c, *spatial)


class TimestepEmbedSequential(nn.Sequential):
    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class UNetModel(nn.Module):
    def __init__(self, image_size, in_channels, model_channels, out_channels, num_res_blocks, attention_resolutions,
                 dropout=0.0, channel_mult=(1, 2, 4, 8), num_head_channels=64):
        super().__init__()
        self.model_channels = model_channels
        time_embed_dim = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, time_embed_dim), nn.SiLU(),
                                        nn.Linear(time_embed_dim, time_embed_dim))
        ch = input_ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(nn.Conv2d(in_channels, ch, 3, padding=1))])
        input_block_chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, time_embed_dim, dropout, out_channels=int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, num_head_channels))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                input_block_chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(ResBlock(ch, time_embed_dim, dropout,
                                                                          out_channels=ch, down=True)))
                input_block_chans.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(ResBlock(ch, time_embed_dim, dropout),
                                                    AttentionBlock(ch, num_head_channels),
                                                    ResBlock(ch, time_embed_dim, dropout))
        self.output_blocks = nn.ModuleList([])
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                ich = input_block_chans.pop()
                layers = [ResBlock(ch + ich, time_embed_dim, dropout, out_channels=int(model_channels * mult))]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, num_head_channels))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, time_embed_dim, dropout, out_channels=ch, up=True))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(normalization(ch), nn.SiLU(), nn.Conv2d(input_ch, out_channels, 3, padding=1))

    def forward(self, x, timesteps):
        hs = []
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        h = x
        for module in self.input_blocks:
            h = module(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for module in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            h = module(h, emb)
        return self.out(h)


def from_flags(image_size, num_channels, channel_mult, num_res_blocks, attention_resolutions, num_head_channels,
               learn_sigma=True, dropout=0.0) -> UNetModel:
    """`script_util.create_model`'s reading of the flags: attention
    resolutions to downsampling rates."""
    return UNetModel(image_size, 3, num_channels, 6 if learn_sigma else 3, num_res_blocks,
                     tuple(image_size // r for r in attention_resolutions), dropout, tuple(channel_mult),
                     num_head_channels)
