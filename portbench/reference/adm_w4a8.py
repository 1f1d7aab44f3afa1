"""Plain PyTorch reference of W4A8 DDIM serving of ADM's UNet.

Written from the published description: ADM's UNet of Dhariwal & Nichol
(2021, arXiv:2105.05233) as openai/guided-diffusion's `unet.py` builds it
(`use_scale_shift_norm`, `resblock_updown`, heads of `num_head_channels`
in the legacy qkv order, GroupNorm eps 1e-5, `learn_sigma`: eps is the first
half of the output), NHWC here with HWIO kernels and q, k, v as separate 1x1
kernels; the DDIM update at eta 0 on eps; and the same post-training
quantization as `ddpm_w4a8.py` (stage-1 calibration on the FP teacher's
trajectory, the per-step W4 fold, int8-resident serving), whose quantizer
helpers it imports unchanged.  It imports nothing of the program under test
and takes nothing it made: weights, images and noise come from the
benchmark.

The parameter tree has the DDPM tree's names (`down.{i}.block.{j}`,
`down.{i}.downsample` a resblock that pools, `up.{i}.upsample` one that
upsamples, `temb_proj` to 2 C_out: scale then shift).

Numerics that the reference fixes on purpose, as `ddpm_w4a8.py` does:
  - every float product runs in float32 with TF32 off (`precision`);
  - int8 x int4 products run as float32 GEMMs on integer values, exact;
  - a resblock whose conv1 output is on the 128 grid (and whose convs have
    at least 64 input channels) hands its 3x3 convs' dequantized outputs on
    in bfloat16 and computes norm2's statistics as E[x^2] - mean^2; its
    scale-shift is folded into norm2's affine (gamma (1 + scale), beta (1 +
    scale) + shift), which every image shares, the timestep being the
    call's; other resblocks run float32 with two-pass statistics;
  - a downsampling resblock pools conv1's input in float32 and then
    quantizes it; an upsampling one quantizes at the low resolution and
    repeats the codes (nearest x2 commutes with the per-channel quantizer);
  - the residual stream between blocks is float32.
"""
from __future__ import annotations

import math

import torch

from .ddpm_w4a8 import (  # noqa: F401  (re-exported: the harness reads them from this module)
    CHUNK_BYTES,
    bits,
    calibrate_site,
    conv2d,
    ddim_update,
    dense,
    fold_conv,
    folded,
    int_conv,
    node,
    precision,
    quantize,
    schedule,
    step_quant,
    swish,
)

GN_GROUPS = 32
GN_EPS = 1e-5


# ---------------------------------------------------------------------------
# the architecture
# ---------------------------------------------------------------------------


def blocks(cfg):
    """[(kind, name, H_in, cin, cout, resample)] of every resblock ("res")
    and attention block ("attn") in forward order; an up block's cin counts
    its concat."""
    m = cfg["model"]
    ch, mult, nrb, attn_res = m["num_channels"], m["channel_mult"], m["num_res_blocks"], m["attention_resolutions"]
    res, c, skips, out = cfg["data"]["image_size"], ch, [ch], []
    for i, k in enumerate(mult):
        for j in range(nrb):
            out.append(("res", f"down.{i}.block.{j}", res, c, ch * k, None))
            c = ch * k
            if res in attn_res:
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
            if res in attn_res:
                out.append(("attn", f"up.{i}.attn.{j}", res, c, c, None))
        if i != 0:
            out.append(("res", f"up.{i}.upsample", res, c, c, "up"))
            res *= 2
    return out


def out_channels(cfg):
    return cfg["data"]["channels"] * (2 if cfg["model"]["learn_sigma"] else 1)


def param_layout(cfg):
    """The parameter tree's shapes: a nested dict / list whose leaves are
    (shape, init) with init "uniform:<fan_in>", "ones" or "zeros"."""
    m = cfg["model"]
    ch, mult, nrb = m["num_channels"], m["channel_mult"], m["num_res_blocks"]
    temb = 4 * ch
    res0 = cfg["data"]["image_size"]

    def conv(k, cin, cout):
        return {"kernel": ((k, k, cin, cout), f"uniform:{k * k * cin}"), "bias": ((cout,), f"uniform:{k * k * cin}")}

    def lin(cin, cout):
        return {"kernel": ((cin, cout), f"uniform:{cin}"), "bias": ((cout,), f"uniform:{cin}")}

    def norm(c):
        return {"scale": ((c,), "ones"), "bias": ((c,), "zeros")}

    def attn_at(i):
        return (res0 >> i) in m["attention_resolutions"]

    tree = {"temb": {"dense0": lin(ch, temb), "dense1": lin(temb, temb)}, "conv_in": conv(3, m["in_channels"], ch),
            "down": [{"block": [None] * nrb, "attn": [None] * (nrb if attn_at(i) else 0)} for i in range(len(mult))],
            "mid": {},
            "up": [{"block": [None] * (nrb + 1), "attn": [None] * (nrb + 1 if attn_at(i) else 0)}
                   for i in range(len(mult))]}
    for kind, name, _h, cin, cout, _rs in blocks(cfg):
        if kind == "attn":
            leaf = {"norm": norm(cin), **{k: conv(1, cin, cin) for k in ("q", "k", "v", "proj_out")}}
        else:
            leaf = {"norm1": norm(cin), "conv1": conv(3, cin, cout), "temb_proj": lin(temb, 2 * cout),
                    "norm2": norm(cout), "conv2": conv(3, cout, cout)}
            if cin != cout:
                leaf["nin_shortcut"] = conv(1, cin, cout)
        parts, at = name.split("."), tree
        for p in parts[:-1]:
            at = at[int(p)] if isinstance(at, list) else at[p]
        if isinstance(at, list):
            at[int(parts[-1])] = leaf
        else:
            at[parts[-1]] = leaf
    tree["norm_out"] = norm(ch * mult[0])
    tree["conv_out"] = conv(3, ch * mult[0], out_channels(cfg))
    return tree


def conv_sites(cfg):
    """[(name, cin, ksize, stride, H_in)] of every conv in forward order (H
    the resolution the conv runs at)."""
    res0 = cfg["data"]["image_size"]
    out = [("conv_in", cfg["model"]["in_channels"], 3, 1, res0)]
    for kind, name, h, cin, cout, rs in blocks(cfg):
        if kind == "attn":
            out += [(f"{name}.{p}", cin, 1, 1, h) for p in ("q", "k", "v", "proj_out")]
            continue
        ho = h // 2 if rs == "down" else 2 * h if rs == "up" else h
        out += [(f"{name}.conv1", cin, 3, 1, ho), (f"{name}.conv2", cout, 3, 1, ho)]
        if cin != cout:
            out.append((f"{name}.nin_shortcut", cin, 1, 1, ho))
    out.append(("conv_out", cfg["model"]["num_channels"] * cfg["model"]["channel_mult"][0], 3, 1, res0))
    return out


def fused(cin, cout):
    """A resblock served in the fused chain: both convs folded, conv1's output on the 128 grid."""
    return cin >= 64 and cout >= 64 and cout % 128 == 0


# ---------------------------------------------------------------------------
# the float forward
# ---------------------------------------------------------------------------


def timestep_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    arg = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=1)


def group_norm(x, p, two_pass=True):
    """GroupNorm(32, eps 1e-5) of NHWC x in float32; the variance as
    E[(x - mean)^2] (`two_pass`) or E[x^2] - mean^2 clamped at 0."""
    B, C = x.shape[0], x.shape[-1]
    g = min(GN_GROUPS, C)
    xg = x.reshape(B, -1, g, C // g).to(torch.float32)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    if two_pass:
        var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    else:
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    return ((xg - mean) / torch.sqrt(var + GN_EPS)).reshape(x.shape) * p["scale"] + p["bias"]


def pool2(x):
    """The 2x2 average pool of NHWC x at stride 2."""
    return (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) / 4.0


def up2(x):
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


def resample(x, rs):
    return x if rs is None else pool2(x.to(torch.float32)) if rs == "down" else up2(x)


def heads_attention(q, k, v, d):
    """softmax(q_h k_h^T / sqrt(d)) v_h per head of d channels, q k v [B, L, C]."""
    B, L, C = q.shape
    qh, kh, vh = (a.reshape(B, L, C // d, d).transpose(1, 2) for a in (q, k, v))
    lg = torch.einsum("bhlc,bhmc->bhlm", qh, kh) * d ** -0.5
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhlm,bhmc->bhlc", e / e.sum(dim=-1, keepdim=True), vh)
    return o.transpose(1, 2).reshape(B, L, C)


def time_embedding(params, cfg, t):
    """The embedding after both dense layers, [N, 4 ch]."""
    return dense(swish(dense(timestep_embedding(t, cfg["model"]["num_channels"]), params["temb"]["dense0"])),
                 params["temb"]["dense1"])


def unet_fp(params, cfg, x, t, conv=None):
    """The float UNet's output at (x [N, H, W, C], t [N]).  `conv(name, x, p,
    stride, pad)` replaces every conv (calibration intercepts there)."""
    conv = conv or (lambda name, h, p, stride, pad: conv2d(h, p, stride, pad))
    d = cfg["model"]["num_head_channels"]
    emb = time_embedding(params, cfg, t)

    def resblock(name, p, h_in, rs):
        h = resample(swish(group_norm(h_in, p["norm1"])), rs)
        h = conv(f"{name}.conv1", h, p["conv1"], 1, None)
        scale, shift = dense(swish(emb), p["temb_proj"]).chunk(2, dim=-1)
        h = swish(group_norm(h, p["norm2"]) * (1 + scale[:, None, None]) + shift[:, None, None])
        h = conv(f"{name}.conv2", h, p["conv2"], 1, None)
        x_sc = resample(h_in, rs)
        if "nin_shortcut" in p:
            x_sc = conv(f"{name}.nin_shortcut", x_sc, p["nin_shortcut"], 1, None)
        return x_sc + h

    def attn(name, p, h_in):
        B, H, W, C = h_in.shape
        hn = group_norm(h_in, p["norm"])
        q, k, v = (conv(f"{name}.{s}", hn, p[s], 1, None).reshape(B, H * W, C) for s in ("q", "k", "v"))
        o = heads_attention(q, k, v, d).reshape(B, H, W, C)
        return h_in + conv(f"{name}.proj_out", o, p["proj_out"], 1, None)

    h = conv("conv_in", x, params["conv_in"], 1, None)
    hs = [h]
    for kind, name, _h, _cin, _cout, rs in blocks(cfg):
        part, p = name.split(".")[0], node(params, name)
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
    return conv("conv_out", swish(group_norm(h, params["norm_out"])), params["conv_out"], 1, None)


def eps_of(out, x):
    """eps: the output's first channels (with `learn_sigma` the rest is the variance's)."""
    return out[..., :x.shape[-1]]


def teacher_inputs(params, cfg, x, sched):
    """The FP teacher's DDIM trajectory from x: each step's model input [S, N, H, W, C]."""
    xs = []
    for t, a, a_next in sched:
        xs.append(x)
        out = unet_fp(params, cfg, x, torch.full((x.shape[0],), float(t), device=x.device))
        x = ddim_update(x, eps_of(out, x), a, a_next)
    return torch.stack(xs)


# ---------------------------------------------------------------------------
# stage-1 calibration and the fold
# ---------------------------------------------------------------------------


def calibrate(params, cfg, xs_in, sched):
    """Stage 1: {conv name: [S, G, 2]} group ranges, as `ddpm_w4a8.calibrate`."""
    S = len(sched)
    ranges = {}
    for s in range(S):
        t = torch.full((xs_in.shape[1],), float(sched[s][0]), device=xs_in.device)

        def conv(name, x, p, stride, pad, s=s):
            _wb, ab, g = bits(cfg, name)
            gr, xq = calibrate_site(x, ab, g)
            ranges.setdefault(name, torch.empty((S, g, 2), device=x.device))[s] = gr
            return conv2d(xq, p, stride, pad)

        unet_fp(params, cfg, xs_in[s], t, conv)
    return ranges


def fold(params, cfg, ranges):
    """{conv name: fold_conv(...)} of every conv served in int8."""
    out = {}
    for name, cin, k, _stride, _h in conv_sites(cfg):
        if folded(cin, k):
            wb, ab, _g = bits(cfg, name)
            p = node(params, name)
            out[name] = fold_conv(p["kernel"], p["bias"], ranges[name], cin, wb, ab)
    return out


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------


class Served:
    """One step of the int8 serving forward over a fold and ranges."""

    def __init__(self, params, cfg, folds, ranges, step, t, device):
        self.params, self.cfg, self.step, self.ranges = params, cfg, step, ranges
        self.f = {name: {k: (v[step] if k in ("codes", "inv_ws", "zcbias", "act_scale", "act_zp") else v)
                         for k, v in f.items()} for name, f in folds.items()}
        self.emb = time_embedding(params, cfg, torch.tensor([float(t)], device=device))

    def quant(self, name, x):
        f = self.f[name]
        return quantize(x, f["act_scale"], f["act_zp"], bits(self.cfg, name)[1])

    def halo(self, name):
        n = 2 ** (bits(self.cfg, name)[1] - 1)
        return torch.clamp(torch.round(-self.f[name]["act_zp"]), -n, n - 1)

    def epilogue(self, name, acc):
        f = self.f[name]
        return acc * f["inv_ws"] + f["zcbias"]

    def conv_any(self, name, x, p):
        """A conv outside the fused chain: int8 with a float32 epilogue where
        folded, else the float conv on its fake-quantized input."""
        k = p["kernel"].shape[0]
        if name in self.f:
            q = self.quant(name, x.to(torch.float32))
            return self.epilogue(name, int_conv(q, self.f[name]["codes"], 1, self.halo(name) if k == 3 else None))
        _wb, ab, _g = bits(self.cfg, name)
        scale, zp = (v[0] for v in step_quant(self.ranges[name][self.step:self.step + 1], ab, x.shape[-1]))
        return conv2d((quantize(x, scale, zp, ab) + zp) / scale, p)

    def resblock(self, name, p, h, rs):
        cin, cout = h.shape[-1], p["conv1"]["kernel"].shape[3]
        scale, shift = dense(swish(self.emb), p["temb_proj"]).chunk(2, dim=-1)
        norm2 = {"scale": p["norm2"]["scale"] * (1 + scale[0]), "bias": p["norm2"]["bias"] * (1 + scale[0]) + shift[0]}
        c1, c2 = f"{name}.conv1", f"{name}.conv2"
        if fused(cin, cout):
            a = swish(group_norm(h, p["norm1"]))
            q = self.quant(c1, pool2(a)) if rs == "down" else resample(self.quant(c1, a), rs)
            y = self.epilogue(c1, int_conv(q, self.f[c1]["codes"], 1, self.halo(c1))).to(torch.bfloat16)
            y = swish(group_norm(y.to(torch.float32), norm2, two_pass=False))
            y = self.epilogue(c2, int_conv(self.quant(c2, y), self.f[c2]["codes"], 1, self.halo(c2)))
            y = y.to(torch.bfloat16).to(torch.float32)
        else:
            y = self.conv_any(c1, resample(swish(group_norm(h, p["norm1"])), rs), p["conv1"])
            y = self.conv_any(c2, swish(group_norm(y, norm2)), p["conv2"])
        x_sc = resample(h, rs).to(torch.float32)
        if "nin_shortcut" in p:
            x_sc = self.conv_any(f"{name}.nin_shortcut", x_sc, p["nin_shortcut"])
        return x_sc + y

    def attn(self, name, p, h):
        B, H, W, C = h.shape
        hn = group_norm(h, p["norm"], two_pass=False).reshape(B, H * W, C)
        q, k, v = (self.conv_any(f"{name}.{s}", hn, p[s]) for s in ("q", "k", "v"))
        o = heads_attention(q, k, v, self.cfg["model"]["num_head_channels"])
        return h + self.conv_any(f"{name}.proj_out", o, p["proj_out"]).reshape(B, H, W, C)

    def forward(self, x):
        params = self.params
        h = self.conv_any("conv_in", x, params["conv_in"])
        hs = [h]
        for kind, name, _h, _cin, _cout, rs in blocks(self.cfg):
            part, p = name.split(".")[0], node(params, name)
            if kind == "attn":
                h = self.attn(name, p, h)
                if part == "down":
                    hs[-1] = h
                continue
            if part == "up" and rs is None:
                h = torch.cat([h, hs.pop()], dim=-1)
            h = self.resblock(name, p, h, rs)
            if part == "down":
                hs.append(h)
        h = self.conv_any("conv_out", swish(group_norm(h, params["norm_out"])), params["conv_out"])
        return h[..., :out_channels(self.cfg)]


def _chunks(cfg, x):
    """x split into chunks of images whose largest im2col (a 3x3 conv at x's
    resolution over four times `num_channels` or x's channels) stays within
    CHUNK_BYTES."""
    per_image = 9 * 4 * max(cfg["model"]["num_channels"], x.shape[3]) * x.shape[1] * x.shape[2] * 4
    return x.split(max(1, CHUNK_BYTES // per_image))


def block_forward(params, cfg, folds, ranges, step, t, name, h):
    """Resblock or attention block `name` of step `step`'s serving forward
    (at timestep t) on its input h [N, H, W, C]: the residual stream out."""
    served, p = Served(params, cfg, folds, ranges, step, t, h.device), node(params, name)
    kind, rs = next((k, r) for k, n, _h, _ci, _co, r in blocks(cfg) if n == name)
    if kind == "attn":
        return torch.cat([served.attn(name, p, hc) for hc in _chunks(cfg, h)])
    return torch.cat([served.resblock(name, p, hc, rs) for hc in _chunks(cfg, h)])


def serve(params, cfg, folds, ranges, sched, x):
    """The int8 serving DDIM sampler from x [N, H, W, C]."""
    outs = []
    for xc in _chunks(cfg, x):
        for s, (t, a, a_next) in enumerate(sched):
            xc = ddim_update(xc, eps_of(Served(params, cfg, folds, ranges, s, t, xc.device).forward(xc), xc), a,
                             a_next)
        outs.append(xc)
    return torch.cat(outs)
