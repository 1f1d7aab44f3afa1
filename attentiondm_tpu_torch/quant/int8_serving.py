"""Fused int8 serving forward and DDIM sampler (port of
`attentiondm_tpu/quant/int8_serving.py` at the serving path's flags).

Activations are int8-resident between convs.  Per resblock:

  entry:   GroupNorm -> swish -> quantize in plain torch (`gn_act_quant_xla`),
           or K4 (`entry_pallas`, where the image fits JAX's budget)
  conv1:   K1, 3x3, bf16 epilogue (`acc*inv_ws + zcbias`)
  middle:  K2 or K6 (ops/fused_gn.py, routed by image size): +temb ->
           GroupNorm -> swish -> int8
  conv2:   K1, 3x3, bf16 epilogue
  exit:    + shortcut (K1 1x1 int8 `nin_shortcut` where channels change), or
           K7 (`boundary_fusion`): the add plus the next block's GroupNorm
           sums, which then skips its statistics pass

With `resblock_pallas` an identity-residual block (no shortcut, no boundary
fusion on either side) is K12 (ops/pallas_resblock.py), the whole chain
behind one call.

Attention blocks route as in JAX (`_attn_fused`): a map that
`fused_attention_block_fits` lets in is K3 (ops/int8_attention.py) whole,
with `int8_core=attn_int8`; a larger one is composed of a plain GroupNorm ->
three quants, three K1 1x1 GEMMs and a core, K9 or K10 at the calibrated
`attn_ranges` (static scales), K8 without them (dynamic scales), or with
`attn_int8=False` the float32 `spatial_attention` (K11 at L >= 1024), then
proj_out's K1 GEMM.  The stride-2 downsample, the int8-domain nearest
upsample and `conv_out` are K1 in int32 mode with a plain-torch dequant.
`conv_in` (3 input channels) stays on the fake-quant float conv.

The port takes the serving path's flag values: bf16 residual stream,
`dot_bf16`, symmetric weights, DDIM update, no step chunking; every value of
`attn_int8` / `attn_ranges`; and JAX's three fusion levers `entry_pallas`,
`boundary_fusion` and `resblock_pallas` (True or "all"), routed by JAX's
predicates.  Every other value raises NotImplementedError naming the ROADMAP
slice that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..diffusion.sampling import _seq_alphas, check_eta, ddim_step
from ..models.unet import (
    UNetConfig,
    check_ported,
    conv2d,
    dense,
    exact_f32,
    get_timestep_embedding,
    iter_conv_layers,
    lookup,
    swish,
)
from ..ops.fused_gn import (
    epilogue_gn_swish_quant,
    epilogue_residual_gn_stats,
    epilogue_residual_gn_stats_fits,
    gn_act_quant,
    gn_act_quant_fits,
    gn_finalize_sums,
    quant_i8 as _quant_i8,
)
from ..ops.attention import spatial_attention
from ..ops.checks import require_attention_kernels
from ..ops.int8_attention import (
    fused_attention_block,
    fused_attention_block_fits,
    fused_int8_attention,
    fused_int8_attention_static,
)
from ..ops.pallas_conv import (
    conv3_pallas_wins,
    int8_conv as _k1,
    k_major,
    pad_qzero as _pad_qzero,
    qzero as _qzero,
)
from ..ops.pallas_resblock import resblock_pallas as _rb_kernel, resblock_pallas_fits
from .int8_runtime import _eligible, _fold_all_steps
from .primitives import div
from .qunet import QuantizedUNet
from .state import ActQuantState, quantize_activation

_CHUNK = "Queue 1, 'chunking and int4 packing'"
_FLAGS = "Queue 1, 'the enhanced variant and the remaining serving flags'"
_SLICE = {
    "step_chunk": _CHUNK,
    "micro_batch": _CHUNK,
    "pack_int4": _CHUNK,
    "rank1": _CHUNK,
    "weight_extras": "Queue 1, 'stage 2/3 calibration and GPTQ/AdaRound'",
    "resblock_pallas": _FLAGS + " (the (H, Cp, Np) shape-list form)",
    "conv_pallas": _FLAGS,
    "mp_states": _FLAGS,
    "symmetric": _FLAGS,
    "residual_dtype": _FLAGS,
    "dot_bf16": _FLAGS,
    "update": "Queue 1, 'runner/CLI, eval, data, parallel and tools' (the ddpm update)",
}

# the serving path's values; anything else raises
_SERVING_FLAGS = dict(
    residual_dtype=torch.bfloat16, dot_bf16=True, conv_pallas=False, mp_states=None,
)


def _require(**flags):
    for name, value in flags.items():
        if name == "resblock_pallas":  # False, True (JAX's per-shape gate) or "all"
            if value is False or value is True or (isinstance(value, str) and value == "all"):
                continue
        else:
            want = {**_SERVING_FLAGS, "step_chunk": None, "micro_batch": None, "pack_int4": False,
                    "rank1": False, "weight_extras": None, "symmetric": True, "update": "ddim"}[name]
            if value is want or value == want:
                continue
        raise NotImplementedError(f"{name}={value!r} is not ported yet; it comes with ROADMAP {_SLICE[name]}")


# ---------------------------------------------------------------------------
# runtime preparation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingLayer:
    """Per-step folded weights + epilogue constants for one conv.

    gq        [S, kh*kw*Cp, Np] int8   scale-folded quantized weights
    gqt       [S, Np, kh*kw*Cp] int8   the same K-major: what the kernels' GEMMs
                                       read (made at fold time; `gq` stays the
                                       layout of JAX's fold and the plain versions)
    inv_ws    [S, Np]                  1 / per-out-channel weight scale
    zcbias    [S, Np]                  zero-point correction + conv bias
    act_scale [S, C]                   input activation quant scale
    act_zp    [S, C]                   input activation zero point
    """

    gq: torch.Tensor
    inv_ws: torch.Tensor
    zcbias: torch.Tensor
    act_scale: torch.Tensor
    act_zp: torch.Tensor
    gqt: torch.Tensor = None

    def __post_init__(self):
        if self.gqt is None:
            self.gqt = k_major(self.gq)


def prepare_serving_runtime(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState],
                            symmetric: bool = True, steps=None, weight_extras=None,
                            pack_int4: bool = False, rank1: bool = False) -> Dict[str, ServingLayer]:
    """Fold weights for every eligible conv into serving form."""
    _require(symmetric=symmetric, step_chunk=steps, weight_extras=weight_extras,
             pack_int4=pack_int4, rank1=rank1)
    runtime: Dict[str, ServingLayer] = {}
    for name, _cin, _k in iter_conv_layers(qunet.cfg):
        node = lookup(params, name)
        kernel = node["kernel"]
        if not _eligible(kernel.shape):
            continue
        st, pol = qstates[name], qunet.policy[name]
        gq, ws, _wzp, zc, scale, zp = _fold_all_steps(kernel, st.group_ranges, st.alpha_logits,
                                                      pol.a_bit, pol.w_bit)
        Np, co = gq.shape[-1], kernel.shape[3]
        bias = F.pad(node["bias"].to(torch.float32), (0, Np - co))
        runtime[name] = ServingLayer(gq=gq, inv_ws=div(1.0, ws), zcbias=zc + bias[None, :],
                                     act_scale=scale, act_zp=zp)
    return runtime


def gather_step(runtime: Dict[str, ServingLayer], step_idx: int) -> Dict[str, ServingLayer]:
    """One sampler step's runtime (views)."""
    return {
        k: ServingLayer(*(a[step_idx] for a in (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp, v.gqt)))
        for k, v in runtime.items()
    }


def runtime_nbytes(runtime: Dict[str, ServingLayer]) -> int:
    return sum(a.numel() * a.element_size() for v in runtime.values()
               for a in (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp, v.gqt))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def gn_act_quant_xla(x, gn_p, quant_params, *, act="swish", sums=None):
    """GroupNorm(32 groups, eps 1e-6) -> act -> quantize in plain torch, two
    passes (stats, then a fused normalize/swish/quantize); one int8 output
    per (scale, zp, bit).

    `sums` [B, 2, G] (K7's, the previous resblock's fused exit) skips the
    statistics pass: mean and rstd come from `gn_finalize_sums`."""
    xf = x.to(torch.float32)
    B, C = xf.shape[0], xf.shape[-1]
    g = min(32, C)
    if sums is None:
        xg = xf.reshape(B, -1, g, C // g)
        mean, rstd = xg.mean(dim=(1, 3)), torch.rsqrt(xg.var(dim=(1, 3), correction=0) + 1e-6)
    else:
        mean, rstd = gn_finalize_sums(sums, xf.numel() // (B * C), C // g)
    shape = (B,) + (1,) * (xf.ndim - 2) + (C,)
    mean_c = mean.repeat_interleave(C // g, dim=1).reshape(shape)
    rstd_c = rstd.repeat_interleave(C // g, dim=1).reshape(shape)
    h = (xf - mean_c) * rstd_c * gn_p["scale"].float() + gn_p["bias"].float()
    if act == "swish":
        h = h * torch.sigmoid(h)
    return tuple(_quant_i8(h, s, z, b) for (s, z, b) in quant_params)


def _entry_gn_quant(h_res, gn_p, quant_params, *, sums=None, entry_pallas=False, plain=False):
    """Resblock / conv_out entry: GN -> swish -> quantize.  `entry_pallas`
    takes K4 where the image fits JAX's one-pass budget; with `sums`
    (boundary fusion) the plain entry is already one pass and stays."""
    if entry_pallas and sums is None:
        C = h_res.shape[-1]
        if gn_act_quant_fits(h_res.numel() // (h_res.shape[0] * C), C):
            return gn_act_quant(h_res, gn_p["scale"], gn_p["bias"], quant_params, plain=plain)
    return gn_act_quant_xla(h_res, gn_p, quant_params, sums=sums)


def _pad_channels(xp, Cp):
    C = xp.shape[-1]
    return xp if C == Cp else F.pad(xp, (0, Cp - C))


def int8_conv(xq, gq_flat, ksize: int, *, gqt=None, plain: bool = False):
    """1x1 int8 NHWC conv (unpadded int8 in) -> int32 [B, H, W, Np] via K1.
    Here and below `gqt` is the fold's K-major copy (`ServingLayer.gqt`),
    which the kernel reads; without it K1 transposes `gq_flat` per call."""
    assert ksize == 1, "use int8_conv3_qzero for 3x3 (quantized-zero halo)"
    return _k1(_pad_channels(xq, gq_flat.shape[0]), gq_flat, ksize=1, gqt=gqt, plain=plain)


def int8_conv3_qzero_down(xq, zp, a_bit, gq_flat, *, gqt=None, plain: bool = False):
    """3x3 stride-2 downsample with the asymmetric (0,1),(0,1) halo of
    quantized zeros -> int32 [B, H/2, W/2, Np] via K1."""
    B, H, W, C = xq.shape
    xp = _qzero(zp, a_bit).expand(B, H + 1, W + 1, C).clone()
    xp[:, :H, :W, :] = xq
    return _k1(_pad_channels(xp, gq_flat.shape[0] // 9), gq_flat, ksize=3, stride=2, gqt=gqt, plain=plain)


def int8_conv3_qzero(xq, zp, a_bit, gq_flat, *, gqt=None, plain: bool = False):
    """3x3 int8 conv with the per-channel quantized-zero halo -> int32 via K1."""
    xp = _pad_channels(_pad_qzero(xq, zp, a_bit), gq_flat.shape[0] // 9)
    return _k1(xp, gq_flat, ksize=3, gqt=gqt, plain=plain)


def _conv3_bf16(xq, zp, a_bit, lay_i: ServingLayer, *, plain: bool = False):
    """3x3 int8 conv -> pre-dequantized bf16 (the dot_bf16 layout) via K1."""
    xp = _pad_channels(_pad_qzero(xq, zp, a_bit), lay_i.gq.shape[0] // 9)
    return _k1(xp, lay_i.gq, lay_i.inv_ws, lay_i.zcbias, ksize=3, out_dtype=torch.bfloat16, gqt=lay_i.gqt,
               plain=plain)


def _epilogue(dot, lay_i: ServingLayer, co: int):
    """int32 accumulator -> f32 output (per-out-channel dequant + bias)."""
    return (dot.to(torch.float32) * lay_i.inv_ws + lay_i.zcbias)[..., :co]


def _conv_any(name, x, p, rt_i, qunet, qstates, step_idx, *, stride=1, padding="SAME",
              plain=False):
    """Single conv outside the fused chains: int8 when the fold covers it,
    the fake-quant float conv otherwise (conv_in)."""
    lay = rt_i.get(name)
    if lay is not None and stride == 1:
        a_bit = qunet.policy[name].a_bit
        xq = _quant_i8(x.to(torch.float32), lay.act_scale, lay.act_zp, a_bit)
        if p["kernel"].shape[0] == 3:
            dot = int8_conv3_qzero(xq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
        else:
            dot = int8_conv(xq, lay.gq, 1, gqt=lay.gqt, plain=plain)
        return _epilogue(dot, lay, p["kernel"].shape[3])
    pol = qunet.policy.get(name)
    if pol is not None and name in qstates:
        xq = quantize_activation(x.to(torch.float32), qstates[name], step_idx, pol.a_bit)
        return conv2d(xq.to(p["kernel"].dtype), p, stride=stride, padding=padding)
    return conv2d(x, p, stride=stride, padding=padding)


def _uncovered(name):
    return NotImplementedError(
        f"{name}: convs the int8 fold does not cover (fewer than 64 input channels, or "
        f"channels off the 128 grid) take the unfused serving branch, not ported yet (ROADMAP {_FLAGS})")


def _resblock_fused(name, p, h_res, temb_act, rt_i, qunet, res_dtype, *, entry_sums=None,
                    want_exit_stats=False, entry_pallas=False, resblock_pallas=False, plain=False):
    """norm1 -> swish -> conv1 -> (+temb) -> norm2 -> swish -> conv2 (+shortcut),
    the `dot_bf16` fused branch.  Returns (residual', exit sums or None).

    Boundary fusion: `entry_sums` are the previous fused exit's GroupNorm
    sums over this block's input (norm1 skips its statistics pass);
    `want_exit_stats` asks the exit for residual' and the next norm1's sums
    in one pass (K7)."""
    c1, c2 = rt_i.get(f"{name}.conv1"), rt_i.get(f"{name}.conv2")
    a1, a2 = qunet.policy[f"{name}.conv1"], qunet.policy[f"{name}.conv2"]
    co1, co2 = p["conv1"]["kernel"].shape[3], p["conv2"]["kernel"].shape[3]
    if c1 is None or c2 is None or c1.zcbias.shape[-1] != co1:
        raise _uncovered(name)
    tproj = dense(swish(temb_act), p["temb_proj"]).to(torch.float32)  # [B, co1]

    # K12: identity-residual blocks outside boundary fusion run whole, gated
    # per shape by JAX's conv policy unless "all"
    if (resblock_pallas and entry_sums is None and not want_exit_stats and "nin_shortcut" not in p
            and h_res.shape[-1] == co1 == co2 and c1.gq.shape[-1] == co1 and c2.gq.shape[-1] == co2):
        B_, H_, W_, C_ = h_res.shape
        if resblock_pallas_fits(B_, H_, W_, C_) and (
                resblock_pallas == "all" or conv3_pallas_wins(B_, H_, W_, C_, C_)):
            out = _rb_kernel(
                h_res, tproj, p["norm1"]["scale"], p["norm1"]["bias"], (c1.act_scale, c1.act_zp), c1.gq,
                (c1.inv_ws, c1.zcbias), p["norm2"]["scale"], p["norm2"]["bias"], (c2.act_scale, c2.act_zp),
                c2.gq, (c2.inv_ws, c2.zcbias), a_bit1=a1.a_bit, a_bit2=a2.a_bit, out_dtype=res_dtype,
                g1_t=c1.gqt, g2_t=c2.gqt, plain=plain)
            return out, None

    (hq,) = _entry_gn_quant(h_res, p["norm1"], [(c1.act_scale, c1.act_zp, a1.a_bit)], sums=entry_sums,
                            entry_pallas=entry_pallas, plain=plain)
    hq2 = epilogue_gn_swish_quant(
        _conv3_bf16(hq, c1.act_zp, a1.a_bit, c1, plain=plain),
        torch.ones_like(c1.inv_ws), torch.zeros_like(c1.zcbias), tproj,
        p["norm2"]["scale"], p["norm2"]["bias"], c2.act_scale, c2.act_zp, a2.a_bit, plain=plain,
    )
    dot2 = _conv3_bf16(hq2, c2.act_zp, a2.a_bit, c2, plain=plain)

    hf = h_res.to(torch.float32)
    if "nin_shortcut" in p:
        sname = f"{name}.nin_shortcut"
        lay = rt_i.get(sname)
        if lay is None:
            raise _uncovered(sname)
        xq = _quant_i8(hf, lay.act_scale, lay.act_zp, qunet.policy[sname].a_bit)
        x_sc = _epilogue(int8_conv(xq, lay.gq, 1, gqt=lay.gqt, plain=plain), lay, p["nin_shortcut"]["kernel"].shape[3])
    else:
        x_sc = hf
    # identity dequant below: dot2 already carries inv_ws + zcbias
    B, Np = dot2.shape[0], dot2.shape[-1]
    if want_exit_stats and Np == co2 and epilogue_residual_gn_stats_fits(dot2.numel() // (B * Np), Np):
        return epilogue_residual_gn_stats(dot2, torch.ones_like(c2.inv_ws), torch.zeros_like(c2.zcbias), x_sc,
                                          out_dtype=res_dtype, plain=plain)
    return (x_sc + dot2.to(torch.float32)[..., :co2]).to(res_dtype), None


def _attn_fused(name, p, h_res, rt_i, qunet, res_dtype, *, attn_int8=True, ar_i=None, plain=False):
    """DDIM single-head attention with int8 q/k/v/proj_out projections.

    Where the map fits JAX's whole-block budget: K3, with `int8_core =
    attn_int8`.  Else the composed branch: one plain GroupNorm pass quantizes
    the normalized tensor at the three projections' scales, the 1x1
    projections are K1 GEMMs to int32, and the core is K9 / K10 at the
    step's calibrated ranges `ar_i` (the quantization at scale absmax / 127
    in plain torch, as XLA fuses it into the projection epilogues), K8
    without them, or with `attn_int8=False` the float32 `spatial_attention`;
    then proj_out's int8 GEMM, dequant and the residual add."""
    B, H, W, C = h_res.shape
    L = H * W
    names = [f"{name}.{k}" for k in ("q", "k", "v", "proj_out")]
    lays = [rt_i.get(n) for n in names]
    pols = [qunet.policy[n] for n in names]
    if any(lay is None for lay in lays):
        raise _uncovered(name)
    lq, lk, lv, lo = lays
    qp = [(lay.act_scale, lay.act_zp, pol.a_bit) for lay, pol in zip(lays[:3], pols[:3])]
    scale = C ** -0.5
    if fused_attention_block_fits(L, C) and all(tuple(lay.gq.shape) == (C, C) for lay in lays):
        out = fused_attention_block(
            h_res.to(res_dtype).reshape(B, L, C),
            p["norm"]["scale"], p["norm"]["bias"], qp,
            [(lay.gq, lay.inv_ws, lay.zcbias, lay.gqt) for lay in lays[:3]],
            (lo.act_scale, lo.act_zp, pols[3].a_bit),
            (lo.gq, lo.inv_ws, lo.zcbias, lo.gqt),
            scale=scale, int8_core=bool(attn_int8), plain=plain,
        )
        return out.reshape(B, H, W, C)
    hf = h_res.to(torch.float32)
    hq, hk, hv = gn_act_quant_xla(hf, p["norm"], qp, act="none")
    if attn_int8 and lq.zcbias.shape[-1] == C:
        dots = [int8_conv(a, lay.gq, 1, gqt=lay.gqt, plain=plain).reshape(B, L, C)
                for a, lay in ((hq, lq), (hk, lk), (hv, lv))]
        scales = None
        if ar_i is not None and all(f"{name}.{k}" in ar_i for k in ("q", "k", "v")):
            scales = [torch.clamp(ar_i[f"{name}.{k}"], min=1e-12) / torch.full_like(ar_i[f"{name}.{k}"], 127.0)
                      for k in ("q", "k", "v")]
        if scales is not None:
            q8, k8, v8 = (
                torch.clamp(torch.round((d.to(torch.float32) * lay.inv_ws + lay.zcbias) / sc), -127, 127).to(torch.int8)
                for d, lay, sc in zip(dots, (lq, lk, lv), scales))
            oq = fused_int8_attention_static(q8, k8, v8, *scales, lo.act_scale, lo.act_zp, pols[3].a_bit,
                                             scale=scale, plain=plain)
        else:
            oq = fused_int8_attention(*dots, (lq.inv_ws, lq.zcbias), (lk.inv_ws, lk.zcbias),
                                      (lv.inv_ws, lv.zcbias), lo.act_scale, lo.act_zp, pols[3].a_bit,
                                      scale=scale, plain=plain)
        oq = oq.reshape(B, H, W, C)
    else:
        q, k, v = (_epilogue(int8_conv(a, lay.gq, 1, gqt=lay.gqt, plain=plain), lay, C).reshape(B, L, C)
                   for a, lay in ((hq, lq), (hk, lk), (hv, lv)))
        h = spatial_attention(q, k, v, scale=scale, plain=plain).reshape(B, H, W, C)
        oq = _quant_i8(h, lo.act_scale, lo.act_zp, pols[3].a_bit)
    out = _epilogue(int8_conv(oq, lo.gq, 1, gqt=lo.gqt, plain=plain), lo, C)
    return (hf + out).to(res_dtype)


# ---------------------------------------------------------------------------
# fused forward
# ---------------------------------------------------------------------------


@exact_f32()
def serving_unet_apply(params, cfg: UNetConfig, qunet: QuantizedUNet,
                       runtime: Dict[str, ServingLayer], qstates: Dict[str, ActQuantState],
                       x: torch.Tensor, t: torch.Tensor, step_idx: int, *,
                       residual_dtype=torch.bfloat16, attn_int8: bool = True, attn_ranges=None,
                       boundary_fusion: bool = False, dot_bf16: bool = True,
                       entry_pallas: bool = False, conv_pallas=False, resblock_pallas=False,
                       mp_states=None, plain=False) -> torch.Tensor:
    """Fused int8-resident forward (eps, float32).  Mirrors
    models/unet.unet_apply at inference.

    The three levers, each routed by JAX's predicates: `entry_pallas` sends
    every resblock and conv_out entry whose image fits through K4;
    `boundary_fusion` fuses a resblock exit with the next block's GroupNorm
    statistics (K7) where that block's norm1 reads exactly the exit's
    tensor; `resblock_pallas` (True: where JAX's conv policy says so; "all":
    wherever it fits) runs identity-residual blocks as K12.

    `attn_int8` (JAX's default, True) runs the attention logits as int8
    products: K3's int8 core where the whole-block kernel takes the map, K8
    on larger maps, or K9 / K10 where `attn_ranges` ({proj_name: [S]} from
    `calibrate_ranges(return_attn_ranges=True)`) has the site's q, k and v.

    `plain=True` runs the kernels' plain versions instead, on any device
    (for comparisons)."""
    _require(residual_dtype=residual_dtype, dot_bf16=dot_bf16, conv_pallas=conv_pallas,
             resblock_pallas=resblock_pallas, mp_states=mp_states)
    check_ported(cfg)
    rt_i = gather_step(runtime, step_idx)
    ar_i = None if attn_ranges is None else {k: a[step_idx] for k, a in attn_ranges.items()}
    attn = dict(attn_int8=attn_int8, ar_i=ar_i, plain=plain)
    num_levels = len(cfg.ch_mult)
    res = residual_dtype
    levers = dict(entry_pallas=bool(entry_pallas), resblock_pallas=resblock_pallas, plain=plain)

    temb = get_timestep_embedding(t, cfg.ch)
    temb = dense(swish(dense(temb, params["temb"]["dense0"])), params["temb"]["dense1"])

    hs = [_conv_any("conv_in", x.to(torch.float32), params["conv_in"], rt_i, qunet, qstates,
                    step_idx, plain=plain).to(res)]
    # boundary fusion: `sums` carries the previous fused exit's GroupNorm sums
    # only while the next consumer is a resblock norm1 over exactly that
    # tensor; attention, downsampling and the up path's concats reset it
    sums = None
    for i_level in range(num_levels):
        lp = params["down"][i_level]
        for i_block in range(cfg.num_res_blocks):
            last_blk = i_block == cfg.num_res_blocks - 1
            want = bool(boundary_fusion) and not lp["attn"] and (not last_blk or i_level == num_levels - 1)
            h, sums = _resblock_fused(f"down.{i_level}.block.{i_block}", lp["block"][i_block], hs[-1],
                                      temb, rt_i, qunet, res, entry_sums=sums, want_exit_stats=want, **levers)
            if lp["attn"]:
                h = _attn_fused(f"down.{i_level}.attn.{i_block}", lp["attn"][i_block], h, rt_i,
                                qunet, res, **attn)
                sums = None
            hs.append(h)
        if i_level != num_levels - 1:
            sums = None
            nm = f"down.{i_level}.downsample.conv"
            lay = rt_i.get(nm)
            if lay is None:
                raise _uncovered(nm)
            # int8 stride-2 downsample (asymmetric quantized-zero pad)
            a_bit = qunet.policy[nm].a_bit
            xq = _quant_i8(hs[-1].to(torch.float32), lay.act_scale, lay.act_zp, a_bit)
            dot = int8_conv3_qzero_down(xq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
            hs.append(_epilogue(dot, lay, lookup(params, nm)["kernel"].shape[3]).to(res))

    h = hs[-1]
    h, _ = _resblock_fused("mid.block_1", params["mid"]["block_1"], h, temb, rt_i, qunet, res,
                           entry_sums=sums, **levers)
    h = _attn_fused("mid.attn_1", params["mid"]["attn_1"], h, rt_i, qunet, res, **attn)
    h, _ = _resblock_fused("mid.block_2", params["mid"]["block_2"], h, temb, rt_i, qunet, res, **levers)

    for i_level in reversed(range(num_levels)):
        lp = params["up"][i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            h, _ = _resblock_fused(f"up.{i_level}.block.{i_block}", lp["block"][i_block],
                                   torch.cat([h, hs.pop()], dim=-1), temb, rt_i, qunet, res, **levers)
            if lp["attn"]:
                h = _attn_fused(f"up.{i_level}.attn.{i_block}", lp["attn"][i_block], h, rt_i,
                                qunet, res, **attn)
        if i_level != 0:
            nm = f"up.{i_level}.upsample.conv"
            lay = rt_i.get(nm)
            if lay is None:
                raise _uncovered(nm)
            # int8-domain nearest upsample: quantize at low resolution, then
            # repeat the int8 entries (nearest resize commutes exactly with
            # per-channel quantization)
            a_bit = qunet.policy[nm].a_bit
            xq = _quant_i8(h.to(torch.float32), lay.act_scale, lay.act_zp, a_bit)
            xq = xq.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            dot = int8_conv3_qzero(xq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
            h = _epilogue(dot, lay, lookup(params, nm)["kernel"].shape[3]).to(res)
    assert not hs

    # norm_out -> swish -> conv_out, int8
    lay = rt_i.get("conv_out")
    if lay is None:
        raise _uncovered("conv_out")
    a_bit = qunet.policy["conv_out"].a_bit
    (hq,) = _entry_gn_quant(h, params["norm_out"], [(lay.act_scale, lay.act_zp, a_bit)],
                            entry_pallas=bool(entry_pallas), plain=plain)
    dot = int8_conv3_qzero(hq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
    return _epilogue(dot, lay, cfg.out_ch).to(torch.float32)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def serving_ddim_sampler(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState], seq,
                         betas: torch.Tensor, *, eta: float = 0.0, step_chunk=None,
                         micro_batch=None, residual_dtype=torch.bfloat16, symmetric: bool = True,
                         attn_int8: bool = True, attn_ranges=None, weight_extras=None,
                         boundary_fusion: bool = False, dot_bf16: bool = True,
                         entry_pallas: bool = False, conv_pallas=False, resblock_pallas=False,
                         pack_int4: bool = False, rank1: bool = False, update: str = "ddim",
                         mp_states=None, runtime=None):
    """Deterministic (eta = 0) DDIM sampler over the fused int8 serving
    path, unchunked: folds every step's weights once (or reuses a prebuilt
    `runtime`), then returns ``sample(x) -> x_final``.

    `runtime`: a prebuilt `prepare_serving_runtime` tree to reuse; samplers
    that differ only in compute-path flags (`attn_int8`, `attn_ranges`,
    `entry_pallas`, `boundary_fusion`, `resblock_pallas`; see
    `serving_unet_apply`) share
    one fold instead of holding a copy each."""
    check_eta(eta)
    _require(step_chunk=step_chunk, micro_batch=micro_batch, update=update,
             residual_dtype=residual_dtype, dot_bf16=dot_bf16, conv_pallas=conv_pallas,
             resblock_pallas=resblock_pallas, mp_states=mp_states)
    t_rev, _, at, at_next = _seq_alphas(betas, seq)
    if runtime is None:
        runtime = prepare_serving_runtime(qunet, params, qstates, symmetric=symmetric,
                                          weight_extras=weight_extras, pack_int4=pack_int4, rank1=rank1)

    def sample(x):
        require_attention_kernels(qunet.cfg, x.device, attn_int8=attn_int8, attn_ranges=attn_ranges)
        n = x.shape[0]
        for i in range(t_rev.shape[0]):
            et = serving_unet_apply(params, qunet.cfg, qunet, runtime, qstates, x,
                                    t_rev[i].to(torch.float32).expand(n), i, attn_int8=attn_int8,
                                    attn_ranges=attn_ranges, boundary_fusion=boundary_fusion,
                                    entry_pallas=entry_pallas, resblock_pallas=resblock_pallas)
            x, _ = ddim_step(x, et, at[i], at_next[i], 0.0, torch.zeros_like(x))
        return x

    sample.runtime = runtime
    return sample
