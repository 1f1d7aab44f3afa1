"""Plain PyTorch reference of W4A8 DDIM serving of the DDPM UNet.

Written from the published description: the DDPM UNet of Ho et al. (2020,
arXiv:2006.11239) as DDIM's `models/diffusion.py` builds it (NHWC here,
HWIO kernels), the DDIM update at eta 0 (Song et al., 2021), and the
post-training quantization of the attentionDM reference repository
(aqilmarwan/attentionDM): per-timestep, group-wise activation ranges
calibrated on the FP teacher's trajectory (stage 1: an LAPQ-style shrink of
the range floor under an L0.5 loss, 8 uniform buckets of channel ranges,
the group-quantized activation propagated downstream), weights quantized
per output channel after the activation scales are folded in, and
int8-resident serving.  It imports nothing of the program under test and
takes nothing it made: weights, images and noise come from the benchmark.

Numerics that the reference fixes on purpose:
  - every float product runs in float32 with TF32 off (`precision="tf32"`
    turns TF32 on: the benchmark's control);
  - int8 x int4 products run as float32 GEMMs on integer values, exact
    (every partial sum is an integer below 2**24);
  - the 3x3 resblock convs hand their dequantized output on in bfloat16
    (the serving path's `dot_bf16` layout), every other conv in float32;
  - the residual stream between blocks is float32.

Functions take `cfg`, the configuration's `model`, `data` and `diffusion`
groups as plain dicts, and `params`, a nested dict / list tree of tensors
(`param_layout` gives its shapes).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

GN_GROUPS = 32
GN_EPS = 1e-6
LAPQ_CANDIDATES = 9
LAPQ_ACCEPT = 0.2
RANGE_FLOOR = (-4.0, 6.0)  # the base activation range each channel covers before the shrink search
ALPHA_INIT = 0.01  # the group-selection logits before stage 2 (uniform: the mixture is the groups' mean)
WEIGHT_SHRINKS = tuple(1.0 - 0.03 * i for i in range(16)) + (0.45, 0.35, 0.25, 0.15)
CHUNK_BYTES = 4 << 30  # a serving forward runs as many images at once as keep its largest im2col under this


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def precision(mode: str = "f32"):
    """float32 products with TF32 off ("f32", the configuration's), or with
    TF32 on in cuDNN and cuBLAS ("tf32", one step below: the control)."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision {mode!r}: 'f32' or 'tf32'")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# the architecture
# ---------------------------------------------------------------------------


def levels(cfg):
    return len(cfg["model"]["ch_mult"])


def param_layout(cfg):
    """The parameter tree's shapes: a nested dict / list whose leaves are
    (shape, init) with init "uniform:<fan_in>" (U(+-1/sqrt(fan_in)), torch's
    default layer init), "ones" or "zeros"."""
    m = cfg["model"]
    ch, mult, nrb = m["ch"], tuple(m["ch_mult"]), m["num_res_blocks"]
    temb_ch = 4 * ch
    in_mult = (1,) + mult

    def conv(k, cin, cout):
        return {"kernel": ((k, k, cin, cout), f"uniform:{k * k * cin}"), "bias": ((cout,), f"uniform:{k * k * cin}")}

    def dense(cin, cout):
        return {"kernel": ((cin, cout), f"uniform:{cin}"), "bias": ((cout,), f"uniform:{cin}")}

    def norm(c):
        return {"scale": ((c,), "ones"), "bias": ((c,), "zeros")}

    def resblock(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout), "temb_proj": dense(temb_ch, cout), "norm2": norm(cout),
             "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    def attn(c):
        return {"norm": norm(c), "q": conv(1, c, c), "k": conv(1, c, c), "v": conv(1, c, c), "proj_out": conv(1, c, c)}

    tree = {"temb": {"dense0": dense(ch, temb_ch), "dense1": dense(temb_ch, temb_ch)},
            "conv_in": conv(3, m["in_channels"], ch)}
    res = cfg["data"]["image_size"]
    down, block_in = [], ch
    for i in range(len(mult)):
        blocks, attns = [], []
        block_in, block_out = ch * in_mult[i], ch * mult[i]
        for _ in range(nrb):
            blocks.append(resblock(block_in, block_out))
            block_in = block_out
            if res in m["attn_resolutions"]:
                attns.append(attn(block_in))
        level = {"block": blocks, "attn": attns}
        if i != len(mult) - 1:
            level["downsample"] = {"conv": conv(3, block_in, block_in)}
            res //= 2
        down.append(level)
    tree["down"] = down
    tree["mid"] = {"block_1": resblock(block_in, block_in), "attn_1": attn(block_in),
                   "block_2": resblock(block_in, block_in)}
    up = [None] * len(mult)
    for i in reversed(range(len(mult))):
        blocks, attns = [], []
        block_out = ch * mult[i]
        for j in range(nrb + 1):
            skip_in = ch * (in_mult[i] if j == nrb else mult[i])
            blocks.append(resblock(block_in + skip_in, block_out))
            block_in = block_out
            if res in m["attn_resolutions"]:
                attns.append(attn(block_in))
        level = {"block": blocks, "attn": attns}
        if i != 0:
            level["upsample"] = {"conv": conv(3, block_in, block_in)}
            res *= 2
        up[i] = level
    tree["up"] = up
    tree["norm_out"] = norm(block_in)
    tree["conv_out"] = conv(3, block_in, m["out_ch"])
    return tree


def node(params, name):
    for part in name.split("."):
        params = params[int(part)] if isinstance(params, list) else params[part]
    return params


def conv_sites(cfg):
    """[(name, cin, ksize, stride, H_in)] of every conv in forward order."""
    m = cfg["model"]
    ch, mult, nrb = m["ch"], tuple(m["ch_mult"]), m["num_res_blocks"]
    in_mult = (1,) + mult
    res = cfg["data"]["image_size"]
    out = [("conv_in", m["in_channels"], 3, 1, res)]

    def attn(prefix, c, h):
        return [(f"{prefix}.{p}", c, 1, 1, h) for p in ("q", "k", "v", "proj_out")]

    block_in = ch
    for i in range(len(mult)):
        block_in, block_out = ch * in_mult[i], ch * mult[i]
        for j in range(nrb):
            name = f"down.{i}.block.{j}"
            out += [(f"{name}.conv1", block_in, 3, 1, res), (f"{name}.conv2", block_out, 3, 1, res)]
            if block_in != block_out:
                out.append((f"{name}.nin_shortcut", block_in, 1, 1, res))
            block_in = block_out
            if res in m["attn_resolutions"]:
                out += attn(f"down.{i}.attn.{j}", block_in, res)
        if i != len(mult) - 1:
            out.append((f"down.{i}.downsample.conv", block_in, 3, 2, res))
            res //= 2
    out += [("mid.block_1.conv1", block_in, 3, 1, res), ("mid.block_1.conv2", block_in, 3, 1, res)]
    out += attn("mid.attn_1", block_in, res)
    out += [("mid.block_2.conv1", block_in, 3, 1, res), ("mid.block_2.conv2", block_in, 3, 1, res)]
    for i in reversed(range(len(mult))):
        block_out = ch * mult[i]
        for j in range(nrb + 1):
            skip_in = ch * (in_mult[i] if j == nrb else mult[i])
            name = f"up.{i}.block.{j}"
            out += [(f"{name}.conv1", block_in + skip_in, 3, 1, res), (f"{name}.conv2", block_out, 3, 1, res)]
            if block_in + skip_in != block_out:
                out.append((f"{name}.nin_shortcut", block_in + skip_in, 1, 1, res))
            block_in = block_out
            if res in m["attn_resolutions"]:
                out += attn(f"up.{i}.attn.{j}", block_in, res)
        if i != 0:
            out.append((f"up.{i}.upsample.conv", block_in, 3, 1, 2 * res))
            res *= 2
    out.append(("conv_out", block_in, 3, 1, res))
    return out


def bits(cfg, name):
    """(w_bit, a_bit, groups) of a conv: the configuration's W/A bits; an
    attention block keeps them on q, v and proj_out, gives the key
    projection max(4, b - 2) bits on both, and v 4 groups of ranges."""
    q = cfg["quant"]
    wb, ab = q["w_bit"], q["a_bit"]
    leaf = name.rsplit(".", 1)[-1]
    if ".attn" in name or name.startswith("mid.attn"):
        if leaf == "k":
            return max(4, wb - 2), max(4, ab - 2), 8
        if leaf == "v":
            return wb, ab, 4
    return wb, ab, 8


def folded(cin, ksize):
    """Convs served in int8: 1x1 or 3x3 with at least 64 input channels."""
    return cin >= 64 and ksize in (1, 3)


# ---------------------------------------------------------------------------
# the float forward
# ---------------------------------------------------------------------------


def timestep_embedding(t, dim):
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000) / (half - 1)))
    arg = t.to(torch.float32)[:, None] * freq[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)


def swish(x):
    return x * torch.sigmoid(x)


def dense(x, p):
    return x @ p["kernel"] + p["bias"]


def conv2d(x, p, stride=1, pad=None):
    k = p["kernel"]
    pad = k.shape[0] // 2 if pad is None else pad
    return F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=stride, padding=pad).permute(0, 2, 3, 1) \
        + p["bias"]


def group_stats(x, two_pass=True):
    """Per-(image, group) mean and 1/sqrt(var + eps) of NHWC x, in float32:
    the variance as E[(x - mean)^2] (`two_pass`) or E[x^2] - mean^2 clamped
    at 0 (the fused epilogues' form)."""
    B, C = x.shape[0], x.shape[-1]
    g = min(GN_GROUPS, C)
    xg = x.reshape(B, -1, g, C // g).to(torch.float32)
    mean = xg.mean(dim=(1, 3))
    if two_pass:
        var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    else:
        var = torch.clamp((xg * xg).mean(dim=(1, 3)) - mean * mean, min=0.0)
    return mean, 1.0 / torch.sqrt(var + GN_EPS)


def group_norm(x, p, two_pass=True):
    B, C = x.shape[0], x.shape[-1]
    mean, rstd = group_stats(x, two_pass)
    cg = C // mean.shape[1]
    shape = (B,) + (1,) * (x.ndim - 2) + (C,)
    mean_c = mean.repeat_interleave(cg, dim=1).reshape(shape)
    rstd_c = rstd.repeat_interleave(cg, dim=1).reshape(shape)
    return (x.to(torch.float32) - mean_c) * rstd_c * p["scale"] + p["bias"]


def attention_core(q, k, v, scale):
    """softmax(q k^T * scale) v, float32, q k v [B, L, C]."""
    lg = torch.einsum("blc,bmc->blm", q, k) * scale
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    return torch.einsum("blm,bmc->blc", e / e.sum(dim=-1, keepdim=True), v)


def unet_fp(params, cfg, x, t, conv=None):
    """eps of the float UNet at (x [N, H, W, C], t [N]).  `conv(name, x, p,
    stride, pad)` replaces every conv (calibration intercepts there); the
    downsample convs receive their input already padded by (0, 1)."""
    m = cfg["model"]
    nlev, nrb = levels(cfg), m["num_res_blocks"]
    conv = conv or (lambda name, h, p, stride, pad: conv2d(h, p, stride, pad))
    temb = dense(swish(dense(timestep_embedding(t, m["ch"]), params["temb"]["dense0"])), params["temb"]["dense1"])

    def resblock(name, p, h):
        y = conv(f"{name}.conv1", swish(group_norm(h, p["norm1"])), p["conv1"], 1, None)
        y = y + dense(swish(temb), p["temb_proj"])[:, None, None, :]
        y = conv(f"{name}.conv2", swish(group_norm(y, p["norm2"])), p["conv2"], 1, None)
        if "nin_shortcut" in p:
            h = conv(f"{name}.nin_shortcut", h, p["nin_shortcut"], 1, None)
        return h + y

    def attn(name, p, h):
        B, H, W, C = h.shape
        hn = group_norm(h, p["norm"])
        q, k, v = (conv(f"{name}.{s}", hn, p[s], 1, None).reshape(B, H * W, C) for s in ("q", "k", "v"))
        o = attention_core(q, k, v, C ** -0.5).reshape(B, H, W, C)
        return h + conv(f"{name}.proj_out", o, p["proj_out"], 1, None)

    hs = [conv("conv_in", x, params["conv_in"], 1, None)]
    for i in range(nlev):
        lp = params["down"][i]
        for j in range(nrb):
            h = resblock(f"down.{i}.block.{j}", lp["block"][j], hs[-1])
            if lp["attn"]:
                h = attn(f"down.{i}.attn.{j}", lp["attn"][j], h)
            hs.append(h)
        if i != nlev - 1:
            hs.append(conv(f"down.{i}.downsample.conv", F.pad(hs[-1], (0, 0, 0, 1, 0, 1)),
                           lp["downsample"]["conv"], 2, 0))
    h = resblock("mid.block_1", params["mid"]["block_1"], hs[-1])
    h = attn("mid.attn_1", params["mid"]["attn_1"], h)
    h = resblock("mid.block_2", params["mid"]["block_2"], h)
    for i in reversed(range(nlev)):
        lp = params["up"][i]
        for j in range(nrb + 1):
            h = resblock(f"up.{i}.block.{j}", lp["block"][j], torch.cat([h, hs.pop()], dim=-1))
            if lp["attn"]:
                h = attn(f"up.{i}.attn.{j}", lp["attn"][j], h)
        if i != 0:
            h = conv(f"up.{i}.upsample.conv", h.repeat_interleave(2, 1).repeat_interleave(2, 2),
                     lp["upsample"]["conv"], 1, None)
    return conv("conv_out", swish(group_norm(h, params["norm_out"])), params["conv_out"], 1, None)


# ---------------------------------------------------------------------------
# the DDIM schedule and update
# ---------------------------------------------------------------------------


def timestep_seq(cfg, steps, skip_type):
    T = cfg["diffusion"]["num_diffusion_timesteps"]
    if skip_type == "uniform":
        skip = T // steps
        return np.arange(0, T, skip) if T % steps == 0 else \
            np.unique(np.floor(np.linspace(0, T - skip, steps)).astype(np.int64))
    if skip_type == "quad":
        return (np.linspace(0, np.sqrt(T * 0.8), steps) ** 2).astype(np.int64)
    raise ValueError(f"skip_type {skip_type!r}: 'uniform' or 'quad'")


def schedule(cfg, steps, skip_type, device):
    """[(t, alpha_bar_t, alpha_bar_next)] in sampling order: the linear beta
    schedule's cumulative products in float32, alpha_bar of step -1 being 1."""
    d = cfg["diffusion"]
    if d["beta_schedule"] != "linear":
        raise ValueError(f"beta_schedule {d['beta_schedule']!r}: the reference takes 'linear'")
    betas = torch.as_tensor(np.linspace(d["beta_start"], d["beta_end"], d["num_diffusion_timesteps"]),
                            dtype=torch.float32, device=device)
    abar = torch.cumprod(1.0 - torch.cat([torch.zeros(1, device=device), betas]), dim=0)
    seq = [int(s) for s in timestep_seq(cfg, steps, skip_type)]
    nxt = [-1] + seq[:-1]
    return [(t, abar[t + 1], abar[tn + 1]) for t, tn in zip(reversed(seq), reversed(nxt))]


def ddim_update(x, e, a, a_next):
    x0 = (x - e * torch.sqrt(1.0 - a)) / torch.sqrt(a)
    return torch.sqrt(a_next) * x0 + torch.sqrt(1.0 - a_next) * e


def teacher_inputs(params, cfg, x, sched):
    """The FP teacher's DDIM trajectory from x: each step's model input [S, N, H, W, C]."""
    xs = []
    for t, a, a_next in sched:
        xs.append(x)
        e = unet_fp(params, cfg, x, torch.full((x.shape[0],), float(t), device=x.device))
        x = ddim_update(x, e, a, a_next)
    return torch.stack(xs)


# ---------------------------------------------------------------------------
# stage-1 calibration
# ---------------------------------------------------------------------------


def quant_params(lo, hi, nbits):
    """(scale, zero point) of signed asymmetric quantization over [lo, hi]."""
    scale = torch.full_like(hi, 2 ** nbits - 1) / (hi - lo)
    return scale, torch.round(scale * lo) + 2 ** (nbits - 1)


def quantize(x, scale, zp, nbits):
    n = 2 ** (nbits - 1)
    return torch.clamp(torch.round(scale * x - zp), -n, n - 1)


def fake_quant(x, lo, hi, nbits):
    scale, zp = quant_params(lo, hi, nbits)
    return (quantize(x, scale, zp, nbits) + zp) / scale


def bucket_ranges(r, groups, upper):
    """Snap channel ranges r [C] to `groups` uniform buckets over [min, max]:
    each bucket's threshold is its members' max (`upper`) or min, a channel
    on a shared edge belongs to the later bucket, and an empty bucket takes
    its upper edge.  Returns the G thresholds."""
    lo, hi = r.min(), r.max()
    edges_hi = lo + (hi - lo) * (torch.arange(1, groups + 1, device=r.device) / groups).to(r.dtype)
    edges_lo = torch.cat([lo[None], edges_hi[:-1]])
    inside = (r[None, :] >= edges_lo[:, None]) & (r[None, :] <= edges_hi[:, None])
    owner = torch.where(inside, torch.arange(groups, device=r.device)[:, None], -1).amax(dim=0)
    member = torch.arange(groups, device=r.device)[:, None] == owner[None, :]
    fill = torch.finfo(r.dtype).max
    if upper:
        vals = torch.where(member, r[None, :], -fill).amax(dim=1)
    else:
        vals = torch.where(member, r[None, :], fill).amin(dim=1)
    return torch.where(member.any(dim=1), vals, edges_hi)


def mixture_quant(x, gr, nbits):
    """The calibration forward's activation: x quantized at each group's
    range and the G results averaged (uniform selection logits)."""
    shape = (gr.shape[0],) + (1,) * x.ndim
    return fake_quant(x[None], gr[:, 0].reshape(shape), gr[:, 1].reshape(shape), nbits).mean(dim=0)


def calibrate_site(x, nbits, groups):
    """One conv's group ranges [G, 2] at one step, from its input x, and the
    quantized x it hands on."""
    axes = tuple(range(x.ndim - 1))
    cmin, cmax = x.amin(dim=axes), x.amax(dim=axes)
    floor = torch.tensor(RANGE_FLOOR, dtype=torch.float32, device=x.device)

    def build(lo, hi):
        return torch.stack([bucket_ranges(torch.minimum(cmin, lo), groups, False),
                            bucket_ranges(torch.maximum(cmax, hi), groups, True)], dim=1)

    scores = []
    for i in range(LAPQ_CANDIDATES):
        f = 1.0 - torch.tensor(float(i), device=x.device) * 0.1
        xq = mixture_quant(x, build(floor[0] * f, floor[1] * f), nbits)
        scores.append((xq - x).abs().sqrt().mean())
    scores = torch.stack(scores)
    best = torch.argmin(scores)
    if scores[best] < LAPQ_ACCEPT:
        floor = floor * (1.0 - best.to(torch.float32) * 0.1)
    gr = build(floor[0], floor[1])
    return gr, mixture_quant(x, gr, nbits)


def calibrate(params, cfg, xs_in, sched):
    """Stage 1: {conv name: [S, G, 2]} group ranges.  Step s runs the float
    UNet on xs_in[s], each conv fed the group-quantized input whose ranges
    it just set."""
    S = len(sched)
    ranges = {}
    for s in range(S):
        t = torch.full((xs_in.shape[1],), float(sched[s][0]), device=xs_in.device)

        def conv(name, x, p, stride, pad, s=s):
            wb, ab, g = bits(cfg, name)
            gr, xq = calibrate_site(x, ab, g)
            ranges.setdefault(name, torch.empty((S, g, 2), device=x.device))[s] = gr
            return conv2d(xq, p, stride, pad)

        unet_fp(params, cfg, xs_in[s], t, conv)
    return ranges


# ---------------------------------------------------------------------------
# the W4 fold
# ---------------------------------------------------------------------------


def step_quant(gr, nbits, channels):
    """Per-step per-channel (scale, zp) [S, C] from group ranges [S, G, 2]:
    each channel's range is the softmax-weighted mixture of the group
    ranges under its selection logits, uniform at stage 1."""
    S, G, _ = gr.shape
    w = torch.softmax(torch.full((S, G, channels), ALPHA_INIT, dtype=gr.dtype, device=gr.device), dim=1)
    return quant_params((gr[:, :, 0:1] * w).sum(dim=1), (gr[:, :, 1:2] * w).sum(dim=1), nbits)


def fold_conv(kernel, bias, gr, cin, w_bit, a_bit):
    """One conv's serving weights for every step: int codes [S, kh, kw, ci,
    co] of g = kernel / act_scale quantized symmetric per output channel at
    w_bit (range shrink searched once on the steps' mean scale), 1 / the
    weight scale [S, co], the zero-point correction plus bias [S, co], and
    the activation (scale, zp) [S, C]."""
    scale, zp = step_quant(gr, a_bit, cin)
    n = 2 ** (w_bit - 1) - 1

    def codes(g, shrink):
        span = torch.clamp(g.abs().amax(dim=(0, 1, 2)), min=1e-8) * shrink
        ws = torch.full_like(span, n) / span
        return torch.clamp(torch.round(ws * g), -n - 1, n), ws

    g_mean = kernel / scale.mean(dim=0).reshape(1, 1, cin, 1)
    errs = []
    for k in WEIGHT_SHRINKS:
        q, ws = codes(g_mean, torch.tensor(k, dtype=kernel.dtype, device=kernel.device))
        errs.append(((q / ws - g_mean) ** 2).sum(dim=(0, 1, 2)))
    shrink = torch.tensor(WEIGHT_SHRINKS, dtype=kernel.dtype, device=kernel.device)[torch.argmin(torch.stack(errs),
                                                                                                  dim=0)]
    out = {"codes": [], "inv_ws": [], "zcbias": [], "act_scale": scale, "act_zp": zp}
    for s in range(scale.shape[0]):
        q, ws = codes(kernel / scale[s].reshape(1, 1, cin, 1), shrink)
        zc = ((q / ws) * zp[s].reshape(1, 1, cin, 1)).sum(dim=(0, 1, 2))
        out["codes"].append(q.to(torch.int8))
        out["inv_ws"].append(torch.ones_like(ws) / ws)
        out["zcbias"].append(zc + bias)
    return {k: torch.stack(v) if isinstance(v, list) else v for k, v in out.items()}


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


def int_conv(q, codes, stride=1, halo=None):
    """Integer conv of codes q [N, H, W, C] (float tensor of integers) with
    weight codes [k, k, C, co]: exact, as a float32 GEMM on integers.  A 3x3
    conv is padded with `halo` [C] (each channel's code for 0.0): by one on
    every side at stride 1, on the bottom and right only at stride 2."""
    k = codes.shape[0]
    w = codes.to(torch.float32)
    with precision("f32"):
        if k == 1:
            return q @ w.reshape(w.shape[2], w.shape[3])
        N, H, W, C = q.shape
        lead = 1 if stride == 1 else 0
        xp = halo.reshape(1, 1, 1, C).expand(N, H + 1 + lead, W + 1 + lead, C).clone()
        xp[:, lead:lead + H, lead:lead + W] = q
        cols = F.unfold(xp.permute(0, 3, 1, 2), kernel_size=3, stride=stride)  # [N, C*9, L], rows (c, ky, kx)
        out = w.permute(3, 2, 0, 1).reshape(w.shape[3], -1) @ cols
        Ho = (H + 1 + lead - 3) // stride + 1
        return out.reshape(N, -1, Ho, Ho).permute(0, 2, 3, 1)


def time_embedding(params, cfg, t, device):
    """The timestep's embedding after both dense layers, [1, 4 ch]."""
    return dense(swish(dense(timestep_embedding(torch.tensor([float(t)], device=device), cfg["model"]["ch"]),
                             params["temb"]["dense0"])), params["temb"]["dense1"])


class Served:
    """One step of the int8 serving forward over a fold and ranges."""

    def __init__(self, params, cfg, folds, ranges, step):
        self.params, self.cfg, self.step = params, cfg, step
        self.f = {name: {k: (v[step] if k in ("codes", "inv_ws", "zcbias", "act_scale", "act_zp") else v)
                         for k, v in f.items()} for name, f in folds.items()}
        self.ranges = ranges

    def quant(self, name, x):
        f = self.f[name]
        return quantize(x, f["act_scale"], f["act_zp"], bits(self.cfg, name)[1])

    def halo(self, name):
        f = self.f[name]
        n = 2 ** (bits(self.cfg, name)[1] - 1)
        return torch.clamp(torch.round(-f["act_zp"]), -n, n - 1)

    def epilogue(self, name, acc):
        f = self.f[name]
        return acc * f["inv_ws"] + f["zcbias"]

    def conv3(self, name, q, stride=1):
        return self.epilogue(name, int_conv(q, self.f[name]["codes"], stride, self.halo(name)))

    def resblock(self, name, p, h, temb):
        y = self.conv3(f"{name}.conv1", self.quant(f"{name}.conv1", swish(group_norm(h, p["norm1"]))))
        y = y.to(torch.bfloat16).to(torch.float32) + dense(swish(temb), p["temb_proj"])[:, None, None, :]
        y = swish(group_norm(y, p["norm2"], two_pass=False))
        y = self.conv3(f"{name}.conv2", self.quant(f"{name}.conv2", y)).to(torch.bfloat16).to(torch.float32)
        if "nin_shortcut" in p:
            sc = f"{name}.nin_shortcut"
            h = self.epilogue(sc, int_conv(self.quant(sc, h), self.f[sc]["codes"]))
        return h + y

    def attn(self, name, p, h):
        B, H, W, C = h.shape
        hn = group_norm(h, p["norm"], two_pass=False).reshape(B, H * W, C)
        q, k, v = (self.epilogue(f"{name}.{s}", int_conv(self.quant(f"{name}.{s}", hn), self.f[f"{name}.{s}"]["codes"]))
                   for s in ("q", "k", "v"))
        o = attention_core(q, k, v, C ** -0.5)
        po = f"{name}.proj_out"
        return h + self.epilogue(po, int_conv(self.quant(po, o), self.f[po]["codes"])).reshape(B, H, W, C)

    def forward(self, x, t):
        cfg, params = self.cfg, self.params
        m = cfg["model"]
        nlev, nrb = levels(cfg), m["num_res_blocks"]
        temb = time_embedding(params, cfg, t, x.device)
        # conv_in (3 input channels, off the fold): the float conv on its group-quantized input
        _wb, ab, _g = bits(cfg, "conv_in")
        scale, zp = (v[0] for v in step_quant(self.ranges["conv_in"][self.step:self.step + 1], ab,
                                              m["in_channels"]))
        hs = [conv2d((quantize(x, scale, zp, ab) + zp) / scale, params["conv_in"])]
        for i in range(nlev):
            lp = params["down"][i]
            for j in range(nrb):
                h = self.resblock(f"down.{i}.block.{j}", lp["block"][j], hs[-1], temb)
                if lp["attn"]:
                    h = self.attn(f"down.{i}.attn.{j}", lp["attn"][j], h)
                hs.append(h)
            if i != nlev - 1:
                name = f"down.{i}.downsample.conv"
                hs.append(self.conv3(name, self.quant(name, hs[-1]), stride=2))
        h = self.resblock("mid.block_1", params["mid"]["block_1"], hs[-1], temb)
        h = self.attn("mid.attn_1", params["mid"]["attn_1"], h)
        h = self.resblock("mid.block_2", params["mid"]["block_2"], h, temb)
        for i in reversed(range(nlev)):
            lp = params["up"][i]
            for j in range(nrb + 1):
                h = self.resblock(f"up.{i}.block.{j}", lp["block"][j], torch.cat([h, hs.pop()], dim=-1), temb)
                if lp["attn"]:
                    h = self.attn(f"up.{i}.attn.{j}", lp["attn"][j], h)
            if i != 0:
                name = f"up.{i}.upsample.conv"
                h = self.conv3(name, self.quant(name, h).repeat_interleave(2, 1).repeat_interleave(2, 2))
        q = self.quant("conv_out", swish(group_norm(h, params["norm_out"])))
        return self.conv3("conv_out", q)[..., :m["out_ch"]]


def _chunks(cfg, x):
    """x split into chunks of images whose largest im2col (a 3x3 conv at
    x's resolution over twice `ch` or twice x's channels) stays within
    CHUNK_BYTES (the UNet treats images independently)."""
    per_image = 9 * 2 * max(cfg["model"]["ch"], x.shape[3]) * x.shape[1] * x.shape[2] * 4
    return x.split(max(1, CHUNK_BYTES // per_image))


def block_forward(params, cfg, folds, ranges, step, t, name, h):
    """Resblock or attention block `name` of step `step`'s serving forward
    (at timestep t) on its input h [N, H, W, C]: the residual stream out."""
    served, p = Served(params, cfg, folds, ranges, step), node(params, name)
    if ".attn" in name:
        return torch.cat([served.attn(name, p, hc) for hc in _chunks(cfg, h)])
    temb = time_embedding(params, cfg, t, h.device)
    return torch.cat([served.resblock(name, p, hc, temb) for hc in _chunks(cfg, h)])


def serve(params, cfg, folds, ranges, sched, x):
    """The int8 serving DDIM sampler from x [N, H, W, C]."""
    outs = []
    for xc in _chunks(cfg, x):
        for s, (t, a, a_next) in enumerate(sched):
            xc = ddim_update(xc, Served(params, cfg, folds, ranges, s).forward(xc, t), a, a_next)
        outs.append(xc)
    return torch.cat(outs)
