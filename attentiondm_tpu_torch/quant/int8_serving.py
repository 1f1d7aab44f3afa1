"""Fused int8 serving forward and DDIM sampler (port of
`attentiondm_tpu/quant/int8_serving.py` at the serving path's flags).

Activations are int8-resident between convs.  Per resblock:

  entry:   GroupNorm -> swish -> quantize on K4 (ops/fused_gn.gn_act_quant)
           wherever one of its forms takes the shape; in plain torch
           (`gn_act_quant_xla`) with K7's sums or where none does
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
with `int8_core=attn_int8`; a larger one is composed of a GroupNorm ->
three quants, three K1 1x1 GEMMs and a core, K9 or K10 at the calibrated
`attn_ranges` (static scales), K8 without them (dynamic scales), or with
`attn_int8=False` the float32 `head_attention` (one head: `spatial_attention`,
K11 at L >= 1024; ADM's several: K11 with heads), then
proj_out's K1 GEMM; its three-output entry is routed as a resblock's.  The
enhanced variant's block (`_attn_fused_enhanced`) has no GroupNorm entry:
its four 1x1 projections are K1 GEMMs on the quantized residual stream
around a float32 (or stage-3 mixed-precision) core in plain torch.  The stride-2 downsample, the int8-domain nearest
upsample and `conv_out` are K1 in int32 mode with a plain-torch dequant.
`conv_in` (3 input channels) stays on the fake-quant float conv.

The fold (`prepare_serving_runtime`) holds every step's int8 weights, or
with `pack_int4` their 4-bit codes two to a byte (one step unpacked in plain
torch before its convs), or with `rank1` one copy shared by every step
(quant/rank1.py).  `serving_ddim_sampler(step_chunk=k)` folds k steps at a
time, and `micro_batch=m` runs each chunk over the batch m images at a time.

The residual stream between blocks is float32 (`residual_dtype`'s default,
as in JAX) or bf16; K3, K4, K7 and K12 read and write it at its dtype.  With
`dot_bf16=False` a resblock's convs are K1 in int32 mode and K2 / K6 (or K7)
dequantize the accumulator themselves; K12 then does not route, as in JAX.
Convs the fold does not cover (fewer than 64 input channels; a resblock
whose conv1 output is off the 128 grid) take JAX's unfused chain: plain
GroupNorm, and each conv through `_conv_any`, K1 in int32 mode where the fold
covers it, the fake-quant float conv elsewhere.  `resamp_with_conv=False`
downsamples by a 2x2 average and upsamples by nearest repetition, no conv.

Every flag value JAX's serving path takes is taken here, the ddpm update and
eta > 0 too (their noise from a `torch.Generator`, or handed in); a value
JAX does not define raises ValueError.  `conv_pallas` takes JAX's
values (False, True, "all", or a collection of (H, Cp, Np) triples): on the
TPU it moved a 3x3 conv from XLA's conv to the Pallas kernel; here every
int8 conv already runs on K1 with its fused epilogue, so every value gives
the same launches and the same output.  `entry_pallas` (True or False) is
alike: on the TPU it moved the entries that fit a VMEM budget to the Pallas
kernel; here every entry K4 takes runs on K4 at either value.  Asymmetric
weight folds are the interception runtime's (quant/int8_runtime.py): `symmetric=False` raises
ValueError here, as JAX refuses it.

While a torch profiler collects, the sampler's call names its parts in the
trace (`utils/profiling.trace_annotation`; with none collecting a span costs
about 0.4 us and records nothing): the containers `adm.sample` (one call,
its kernel-plan checks included), `adm.step` (the forward and the update)
and `adm.attn` (one attention block), and the leaves `adm.views` (the
step's views of the fold, `gather_step`), `adm.temb` (the time embedding,
each resblock's projection of it), `adm.entry` (each GroupNorm ->
swish -> quantize entry in plain torch or K4), `adm.halo` (each K1 input's
quantized-zero halo and channel pad), `adm.quant_io` (the quantize before and
the dequant after each K1 GEMM outside the fused resblock chain, and the
fake quantization of convs off the fold), `adm.exit` (each block's slice,
casts and residual add, or K7), `adm.skip` (the decoder's concat) and
`adm.update` (the DDIM / DDPM rule), and on ADM's graph `adm.resample` (the
pool or nearest x2 of a resampling resblock's branch and skip; the
embedding projection and the scale-shift fold are `adm.temb`'s).  No leaf
opens inside another.

ADM's UNet (`cfg.model_type == "adm"`, models/adm.py) serves through the
same kernels (`_serving_adm_apply`, `_resblock_adm`): its resblocks fold the
timestep's scale-shift into norm2's affine (K2 / K6 with a zero temb), its
resampling resblocks pool before (down) or upsample the int8 codes after
(up) the entry's quantizer, and its multi-head attention blocks take the
composed branch around K11 with heads; every GroupNorm at its eps 1e-5.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from ..diffusion.sampling import _seq_alphas, step_rule
from ..models.adm import adm_blocks, adm_timestep_embedding, heads_of, scale_shift
from ..models.unet import (
    UNetConfig,
    avg_pool2,
    check_ported,
    conv2d,
    dense,
    enhanced_core,
    exact_f32,
    get_timestep_embedding,
    group_norm,
    iter_conv_layers,
    lookup,
    nearest_up2,
    swish,
)
from ..ops.fused_gn import (
    GN_EPS,
    RESIDUAL_DTYPES,
    epilogue_gn_swish_quant,
    epilogue_residual_gn_stats,
    epilogue_residual_gn_stats_fits,
    gn_act_quant,
    gn_act_quant_takes,
    gn_finalize_sums,
    quant_i8 as _quant_i8,
)
from ..ops.attention import head_attention
from ..ops.checks import require_attention_kernels, require_gn_kernels
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
from ..ops.quant_conv import _round_up
from ..utils.profiling import trace_annotation
from .int8_runtime import _eligible, _fold_all_steps
from .primitives import div
from .qunet import QuantizedUNet
from .state import ActQuantState, quantize_activation

def _conv_pallas_ok(value) -> bool:
    """JAX's values of `conv_pallas`: False, True, "all", or a collection of
    (H, Cp, Np) triples of ints."""
    if value is False or value is True or (isinstance(value, str) and value == "all"):
        return True
    return isinstance(value, (tuple, list, set, frozenset)) and all(
        isinstance(t, (tuple, list)) and len(t) == 3 and all(isinstance(i, int) for i in t) for t in value)


def _check_flags(*, residual_dtype, dot_bf16, entry_pallas, conv_pallas, resblock_pallas):
    """The compute-path flags of `serving_unet_apply`: JAX's values are
    taken; any other raises ValueError, where JAX would treat it as some
    other value (a truthy `resblock_pallas` or `conv_pallas` as True) or fail
    later."""
    if residual_dtype not in RESIDUAL_DTYPES:
        raise ValueError(f"residual_dtype={residual_dtype!r}: the residual stream is torch.float32 (JAX's default) "
                         "or torch.bfloat16")
    if dot_bf16 is not True and dot_bf16 is not False:
        raise ValueError(f"dot_bf16={dot_bf16!r}: True or False")
    if entry_pallas is not True and entry_pallas is not False:
        raise ValueError(f"entry_pallas={entry_pallas!r}: True or False")
    if not _conv_pallas_ok(conv_pallas):
        raise ValueError(f"conv_pallas={conv_pallas!r}: False, True, 'all' or a collection of (H, Cp, Np) triples")
    if not (resblock_pallas is False or resblock_pallas is True
            or (isinstance(resblock_pallas, str) and resblock_pallas == "all")):
        raise ValueError(f"resblock_pallas={resblock_pallas!r}: False, True (JAX's per-shape gate) or 'all'")


def _check_update(update):
    if update not in ("ddim", "ddpm"):
        raise ValueError(f"update must be 'ddim' or 'ddpm', got {update!r}")


def _require_symmetric(symmetric):
    """The serving epilogue has no rowsum term: asymmetric weight folds are
    the interception runtime's, as in JAX."""
    if not symmetric:
        raise ValueError("the fused serving path folds symmetric weights only (its epilogue has no rowsum term); "
                         "asymmetric weight quantization is the interception runtime's: "
                         "quant/int8_runtime.prepare_int8_runtime(symmetric=False) with int8_model_fn")


def _require_attention_flags(cfg: UNetConfig, attn_int8, attn_ranges, mp_states) -> bool:
    """The value of `attn_int8` for the config's variant: None is the
    variant's own (True on the ddim block, JAX's default; False on the
    enhanced one, whose core is float32).  A flag that does not apply to the
    variant raises (JAX ignores it): the enhanced block's core is always
    float32 (or the mixed-precision one), so it takes neither an explicit
    `attn_int8=True` nor `attn_ranges`; the ddim block has no
    mixed-precision core, so it takes no `mp_states`."""
    enhanced = cfg.attn_variant == "enhanced"
    if cfg.model_type == "adm":
        if attn_int8 or attn_ranges is not None or mp_states:
            raise ValueError("ADM's multi-head blocks take the float32 core (K11 with heads): pass attn_int8=False "
                             f"or None and no attn_ranges or mp_states (got attn_int8={attn_int8!r})")
        return False
    if enhanced and (attn_int8 or attn_ranges is not None):
        raise ValueError("the enhanced attention variant's core is float32 (or the stage-3 mixed-precision core): "
                         f"pass attn_int8=False or None and no attn_ranges (got attn_int8={attn_int8!r}, "
                         f"attn_ranges {'given' if attn_ranges is not None else 'None'})")
    if not enhanced and mp_states:
        raise ValueError("mp_states (the stage-3 mixed-precision core) apply to the enhanced attention variant only")
    return not enhanced if attn_int8 is None else bool(attn_int8)


# ---------------------------------------------------------------------------
# runtime preparation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingLayer:
    """Per-step folded weights + epilogue constants for one conv.

    gqt       [S, Np, kh*kw*Cp] int8   scale-folded quantized weights, K-major:
                                       what the kernels' GEMMs read, the one
                                       copy of the fold held
    gq        [S, kh*kw*Cp, Np] int8   the layout of JAX's fold, which the plain
                                       versions read: a view of `gqt`
                                       (`gqt.transpose(-1, -2)`), never a copy
    inv_ws    [S, Np]                  1 / per-out-channel weight scale
    zcbias    [S, Np]                  zero-point correction + conv bias
    act_scale [S, C]                   input activation quant scale
    act_zp    [S, C]                   input activation zero point

    Made from `gq` (transposed once into `gqt`, and `gq` dropped for the
    view) or from `gqt` alone (`gq=None`).
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
        self.gq = self.gqt.transpose(-1, -2)


# ---------------------------------------------------------------------------
# int4 nibble packing (half the fold's bytes, bit-exact)
# ---------------------------------------------------------------------------


def pack_int4(gqt):
    """Pack int8 codes of 4-bit weights ([-8, 7]) along the last axis, the K
    of the K-major fold: int8 [..., Np, K] -> uint8 [..., Np, K / 2], codes
    (2j, 2j + 1) in the (low, high) nibbles of byte j.  These are the bytes of
    JAX's `pack_int4` of the [K, Np] fold, transposed.  K is even (the fold
    pads channels to 128)."""
    K = gqt.shape[-1]
    if K % 2:
        raise ValueError(f"pack_int4: K={K} is odd")
    r = gqt.reshape(*gqt.shape[:-1], K // 2, 2).to(torch.int16)
    return ((r[..., 0] & 0x0F) | ((r[..., 1] & 0x0F) << 4)).to(torch.uint8)


def unpack_int4(packed, out=None):
    """Inverse of `pack_int4`: uint8 [..., Kh] -> int8 [..., 2 Kh], the low
    nibble first, each sign-extended ((x << 4) >> 4 and x >> 4 on int8).  Three
    elementwise passes over the buffer, written into `out` (int8, 2 Kh
    elements a row) where it is given."""
    p = packed.view(torch.int8)
    if out is None:
        out = torch.empty((*p.shape[:-1], 2 * p.shape[-1]), dtype=torch.int8, device=p.device)
    pairs = out.view(*p.shape, 2)
    torch.bitwise_left_shift(p, 4, out=pairs[..., 0])
    pairs[..., 1].copy_(p)
    out.bitwise_right_shift_(4)
    return out


_pack_int4 = pack_int4  # `prepare_serving_runtime` has a keyword of that name


class ServingRuntime(dict):
    """{conv name: ServingLayer}: a fold.  With `pack_int4` it also holds
    `packed`, uint8 [S, T]: every packed layer's K-major 4-bit codes, a step
    a row (`offsets` {name: first byte of its layer in a row}; the layer's
    `gqt` is a view of it), and `unpacked`, int8 [2 T]: one step's codes,
    into which `gather_step` unpacks the row of its step in one pass."""

    def __init__(self, layers=(), packed=None, offsets=None):
        super().__init__(layers)
        self.packed = packed
        self.offsets = offsets or {}
        self.unpacked = None if packed is None else torch.empty(2 * packed.shape[1], dtype=torch.int8,
                                                                device=packed.device)


def _fold_shape(kernel_shape):
    """(K, Np) of a conv's fold: rows kh * kw * Cp and columns on the 128 grid."""
    kh, kw, ci, co = kernel_shape
    return kh * kw * _round_up(ci, 128), _round_up(co, 128)


def prepare_serving_runtime(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState],
                            symmetric: bool = True, steps=None, weight_extras=None,
                            pack_int4: bool = False, rank1: bool = False) -> ServingRuntime:
    """Fold weights for every eligible conv into serving form.

    `steps` (a slice of the schedule) folds those steps only, the chunk of
    `serving_ddim_sampler(step_chunk=)`.  `pack_int4` holds each layer of at
    most 4 weight bits as two codes a byte (`pack_int4`), all of them in one
    buffer (`ServingRuntime.packed`): half the fold's bytes, bit-exact.
    `rank1` folds the weights once for every step on rank-1 activation
    scales (quant/rank1.py); it needs the whole schedule, so it refuses
    `steps`.

    `weight_extras` {name: quant.adaround.WeightExtras} (AdaRound or GPTQ
    offsets, bias-correction means, pinned shrinks, refinements) change the
    fold only; the kernels are the same.  An empty dict is no extras.

    `symmetric=False` raises ValueError: the serving epilogue has no rowsum
    term, so asymmetric folds are the interception runtime's
    (quant/int8_runtime.py), as in JAX."""
    _require_symmetric(symmetric)
    if rank1 and steps is not None:
        raise ValueError("rank1 shared folds are whole-schedule by construction; drop step_chunk (the shared "
                         "fold is params-sized, chunking buys nothing)")
    layers = []
    for name, _cin, _k in iter_conv_layers(qunet.cfg):
        node = lookup(params, name)
        if _eligible(node["kernel"].shape):
            layers.append((name, node))
    offsets, total = {}, 0  # a packed layer's first byte in a row of the one buffer, a step a row
    if pack_int4:
        for name, node in layers:
            if qunet.policy[name].w_bit <= 4:
                K, Np = _fold_shape(node["kernel"].shape)
                offsets[name], total = total, total + K * Np // 2
    folded, packed = {}, None
    for name, node in layers:
        kernel = node["kernel"]
        st, pol = qstates[name], qunet.policy[name]
        ex = weight_extras.get(name) if weight_extras else None
        extras = {} if ex is None else dict(round_offset=ex.round_offset, input_mu=ex.mu, shrink=ex.shrink,
                                            out_mult=ex.out_mult, bias_delta=ex.bias_delta)
        gq, ws, _wzp, zc, scale, zp = _fold_all_steps(kernel, st.group_ranges, st.alpha_logits, pol.a_bit,
                                                      pol.w_bit, rank1=rank1, steps=steps, **extras)
        S, K, Np = gq.shape
        bias = F.pad(node["bias"].to(torch.float32), (0, Np - kernel.shape[3]))
        gqt = k_major(gq)
        del gq
        if name in offsets:
            if packed is None:
                packed = torch.empty((S, total), dtype=torch.uint8, device=gqt.device)
            view = packed[:, offsets[name]:offsets[name] + Np * K // 2].view(S, Np, K // 2)
            view.copy_(_pack_int4(gqt))
            gqt = view
        folded[name] = ServingLayer(gq=None, inv_ws=div(1.0, ws), zcbias=zc + bias[None, :], act_scale=scale,
                                    act_zp=zp, gqt=gqt)
    return ServingRuntime(folded, packed=packed, offsets=offsets)


def gather_step(runtime: Dict[str, ServingLayer], step_idx: int) -> Dict[str, ServingLayer]:
    """One sampler step's runtime (views; `gq` a view of the step's `gqt`).
    A tensor with a singleton step axis (the rank-1 fold's `gqt`) is shared
    by every step and gives its index 0.  A packed fold's step is first
    unpacked, every layer in one pass, into the runtime's `unpacked` buffer,
    of which the step's int8 `gqt` are views."""
    def at(a):
        return a[0] if a.shape[0] == 1 else a[step_idx]

    packed = getattr(runtime, "packed", None)
    if packed is not None:
        unpack_int4(at(packed), out=runtime.unpacked)
    step = {}
    for k, v in runtime.items():
        gqt = at(v.gqt)
        if packed is not None and k in runtime.offsets:
            Np, Kh = gqt.shape
            o = 2 * runtime.offsets[k]
            gqt = runtime.unpacked[o:o + 2 * Np * Kh].view(Np, 2 * Kh)
        step[k] = ServingLayer(None, *(at(a) for a in (v.inv_ws, v.zcbias, v.act_scale, v.act_zp)), gqt=gqt)
    return step


def runtime_nbytes(runtime: Dict[str, ServingLayer]) -> int:
    """Device bytes of a runtime, each storage counted once (`gq` is a view
    of `gqt`; a packed fold's layers are views of its one buffer, and its
    step buffer counts too)."""
    storages = {}
    extra = [t for t in (getattr(runtime, "packed", None), getattr(runtime, "unpacked", None)) if t is not None]
    for a in extra + [a for v in runtime.values() for a in (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp, v.gqt)]:
        st = a.untyped_storage()
        storages[(st.device, st.data_ptr())] = st.nbytes()
    return sum(storages.values())


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def gn_act_quant_xla(x, gn_p, quant_params, *, act="swish", sums=None, eps=GN_EPS):
    """GroupNorm(32 groups, `eps`) -> act -> quantize in plain torch, two
    passes (stats, then a fused normalize/swish/quantize); one int8 output
    per (scale, zp, bit).

    `sums` [B, 2, G] (K7's, the previous resblock's fused exit) skips the
    statistics pass: mean and rstd come from `gn_finalize_sums`."""
    xf = x.to(torch.float32)
    B, C = xf.shape[0], xf.shape[-1]
    g = min(32, C)
    if sums is None:
        xg = xf.reshape(B, -1, g, C // g)
        mean, rstd = xg.mean(dim=(1, 3)), torch.rsqrt(xg.var(dim=(1, 3), correction=0) + eps)
    else:
        mean, rstd = gn_finalize_sums(sums, xf.numel() // (B * C), C // g, eps)
    shape = (B,) + (1,) * (xf.ndim - 2) + (C,)
    mean_c = mean.repeat_interleave(C // g, dim=1).reshape(shape)
    rstd_c = rstd.repeat_interleave(C // g, dim=1).reshape(shape)
    h = (xf - mean_c) * rstd_c * gn_p["scale"].float() + gn_p["bias"].float()
    if act == "swish":
        h = h * torch.sigmoid(h)
    return tuple(_quant_i8(h, s, z, b) for (s, z, b) in quant_params)


def _entry_gn_quant(h_res, gn_p, quant_params, *, act="swish", sums=None, eps=GN_EPS, plain=False):
    """A GroupNorm -> act -> quantize entry (a resblock's norm1, conv_out's
    norm_out, a composed attention block's norm with three outputs): K4
    wherever `gn_act_quant_takes` admits the shape, its plain version with
    `plain` or on the CPU.  With `sums` (boundary fusion) the plain entry is
    already one pass and stays, as it does where no form of K4 takes the
    shape.  `eps` is the model's GroupNorm eps."""
    with trace_annotation("adm.entry"):
        if sums is None:
            B, C = h_res.shape[0], h_res.shape[-1]
            if gn_act_quant_takes(B, h_res.numel() // (B * C), C, h_res.dtype, len(quant_params)):
                return gn_act_quant(h_res, gn_p["scale"], gn_p["bias"], quant_params, act=act, eps=eps,
                                    plain=plain)
        return gn_act_quant_xla(h_res, gn_p, quant_params, act=act, sums=sums, eps=eps)


def _pad_channels(xp, Cp):
    C = xp.shape[-1]
    return xp if C == Cp else F.pad(xp, (0, Cp - C))


def int8_conv(xq, gq_flat, ksize: int, *, gqt=None, plain: bool = False):
    """1x1 int8 NHWC conv (unpadded int8 in) -> int32 [B, H, W, Np] via K1.
    Here and below `gqt` is the fold's K-major copy (`ServingLayer.gqt`),
    which the kernel reads; without it K1 transposes `gq_flat` per call."""
    assert ksize == 1, "use int8_conv3_qzero for 3x3 (quantized-zero halo)"
    with trace_annotation("adm.halo"):
        xp = _pad_channels(xq, gq_flat.shape[0])
    return _k1(xp, gq_flat, ksize=1, gqt=gqt, plain=plain)


def int8_conv3_qzero_down(xq, zp, a_bit, gq_flat, *, gqt=None, plain: bool = False):
    """3x3 stride-2 downsample with the asymmetric (0,1),(0,1) halo of
    quantized zeros -> int32 [B, H/2, W/2, Np] via K1."""
    B, H, W, C = xq.shape
    with trace_annotation("adm.halo"):
        xp = _qzero(zp, a_bit).expand(B, H + 1, W + 1, C).clone()
        xp[:, :H, :W, :] = xq
        xp = _pad_channels(xp, gq_flat.shape[0] // 9)
    return _k1(xp, gq_flat, ksize=3, stride=2, gqt=gqt, plain=plain)


def int8_conv3_qzero(xq, zp, a_bit, gq_flat, *, gqt=None, plain: bool = False):
    """3x3 int8 conv with the per-channel quantized-zero halo -> int32 via K1."""
    with trace_annotation("adm.halo"):
        xp = _pad_channels(_pad_qzero(xq, zp, a_bit), gq_flat.shape[0] // 9)
    return _k1(xp, gq_flat, ksize=3, gqt=gqt, plain=plain)


def _conv3_bf16(xq, zp, a_bit, lay_i: ServingLayer, *, plain: bool = False):
    """3x3 int8 conv -> pre-dequantized bf16 (the dot_bf16 layout) via K1."""
    with trace_annotation("adm.halo"):
        xp = _pad_channels(_pad_qzero(xq, zp, a_bit), lay_i.gq.shape[0] // 9)
    return _k1(xp, lay_i.gq, lay_i.inv_ws, lay_i.zcbias, ksize=3, out_dtype=torch.bfloat16, gqt=lay_i.gqt,
               plain=plain)


def _conv3_dot(xq, zp, a_bit, lay_i: ServingLayer, dot_bf16: bool, *, plain: bool = False):
    """A fused resblock's 3x3 conv -> (its output, the (inv_ws, zcbias) the
    kernel reading it applies): with `dot_bf16` K1's bf16 mode, its dequant
    fused, and identity vectors; without, K1's int32 accumulator and the
    layer's own vectors."""
    if dot_bf16:
        return _conv3_bf16(xq, zp, a_bit, lay_i, plain=plain), _identity_of(lay_i.inv_ws)
    return int8_conv3_qzero(xq, zp, a_bit, lay_i.gq, gqt=lay_i.gqt, plain=plain), (lay_i.inv_ws, lay_i.zcbias)


def _epilogue(dot, lay_i: ServingLayer, co: int):
    """int32 accumulator -> f32 output (per-out-channel dequant + bias)."""
    return (dot.to(torch.float32) * lay_i.inv_ws + lay_i.zcbias)[..., :co]


def _conv_any(name, x, p, rt_i, qunet, qstates, step_idx, *, stride=1, padding="SAME",
              plain=False):
    """Single conv outside the fused chains: int8 (K1, int32 mode) when the
    fold covers it at stride 1, the fake-quant float conv otherwise (conv_in,
    convs of fewer than 64 input channels, a downsample conv off the fold),
    or the float conv where the conv has no quant state."""
    lay = rt_i.get(name)
    if lay is not None and stride == 1:
        a_bit = qunet.policy[name].a_bit
        with trace_annotation("adm.quant_io"):
            xq = _quant_i8(x.to(torch.float32), lay.act_scale, lay.act_zp, a_bit)
        if p["kernel"].shape[0] == 3:
            dot = int8_conv3_qzero(xq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
        else:
            dot = int8_conv(xq, lay.gq, 1, gqt=lay.gqt, plain=plain)
        with trace_annotation("adm.quant_io"):
            return _epilogue(dot, lay, p["kernel"].shape[3])
    pol = qunet.policy.get(name)
    if pol is not None and name in qstates:
        with trace_annotation("adm.quant_io"):
            xq = quantize_activation(x.to(torch.float32), qstates[name], step_idx, pol.a_bit).to(p["kernel"].dtype)
        return conv2d(xq, p, stride=stride, padding=padding)
    return conv2d(x, p, stride=stride, padding=padding)


@functools.lru_cache(maxsize=None)
def _identity_dequant(n: int, dtype, device):
    """(ones [n], zeros [n]): the inv_ws / zcbias handed to K2 and K7 for a
    conv output that already carries its dequant, made once a width."""
    return torch.ones(n, dtype=dtype, device=device), torch.zeros(n, dtype=dtype, device=device)


def _identity_of(v):
    return _identity_dequant(v.shape[-1], v.dtype, v.device)


def _shortcut(name, p, h_res, rt_i, qunet, qstates, step_idx, *, plain=False):
    """The resblock's shortcut: the identity, `h_res` in the stream's dtype
    (K7 reads it as it is; its f32 conversion is exact, so these are the bits
    of an f32 copy without the copy), or the 1x1 `nin_shortcut` through
    `_conv_any`, as JAX."""
    if "nin_shortcut" not in p:
        return h_res
    return _conv_any(f"{name}.nin_shortcut", h_res.to(torch.float32), p["nin_shortcut"], rt_i, qunet, qstates,
                     step_idx, plain=plain)


def _resblock_fused(name, p, h_res, temb_act, rt_i, qunet, res_dtype, *, qstates=None, step_idx=0, entry_sums=None,
                    want_exit_stats=False, dot_bf16=True, resblock_pallas=False, resample=None, plain=False):
    """norm1 -> swish -> conv1 -> (+temb) -> norm2 -> swish -> conv2 (+shortcut),
    fused where the fold covers both convs with conv1's output unpadded
    (JAX's `fused`).  Returns (residual', exit sums or None).  An ADM
    resblock (`qunet.cfg.model_type == "adm"`) is `_resblock_adm`'s, with
    its `resample` ("down", "up" or None).

    `dot_bf16`: each conv is K1 with its dequant fused, writing bf16, and
    K2 / K6 read that; without it the convs write K1's int32 accumulator and
    K2 / K6 (or K7) dequantize it with `inv_ws` / `zcbias`.  A block the fold
    does not cover runs JAX's unfused chain (plain GroupNorm, `_conv_any`).

    Boundary fusion: `entry_sums` are the previous fused exit's GroupNorm
    sums over this block's input (norm1 skips its statistics pass);
    `want_exit_stats` asks the exit for residual' and the next norm1's sums
    in one pass (K7)."""
    if _is_adm(qunet):
        return _resblock_adm(name, p, h_res, temb_act, rt_i, qunet, res_dtype, qstates=qstates, step_idx=step_idx,
                             dot_bf16=dot_bf16, resample=resample, plain=plain)
    c1, c2 = rt_i.get(f"{name}.conv1"), rt_i.get(f"{name}.conv2")
    a1, a2 = qunet.policy[f"{name}.conv1"], qunet.policy[f"{name}.conv2"]
    co1, co2 = p["conv1"]["kernel"].shape[3], p["conv2"]["kernel"].shape[3]
    # [B, co1]; from a shared timestep's one row (serving_unet_apply), expanded over the batch
    with trace_annotation("adm.temb"):
        tproj = dense(swish(temb_act), p["temb_proj"]).to(torch.float32).expand(h_res.shape[0], -1)

    if not (c1 is not None and c2 is not None and c1.zcbias.shape[-1] == co1):
        # the unfused chain, each conv dispatched on its own
        with trace_annotation("adm.entry"):
            h = swish(group_norm(h_res.to(torch.float32), p["norm1"]))
        h = _conv_any(f"{name}.conv1", h, p["conv1"], rt_i, qunet, qstates, step_idx, plain=plain)
        with trace_annotation("adm.entry"):
            h = swish(group_norm(h + tproj[:, None, None, :], p["norm2"]))
        h = _conv_any(f"{name}.conv2", h, p["conv2"], rt_i, qunet, qstates, step_idx, plain=plain)
        x_sc = _shortcut(name, p, h_res, rt_i, qunet, qstates, step_idx, plain=plain)
        with trace_annotation("adm.exit"):
            return (x_sc.to(torch.float32) + h).to(res_dtype), None

    # K12: identity-residual blocks outside boundary fusion run whole, gated
    # per shape by JAX's conv policy unless "all"
    if (dot_bf16 and resblock_pallas and entry_sums is None and not want_exit_stats and "nin_shortcut" not in p
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
                            plain=plain)
    dot1, epi1 = _conv3_dot(hq, c1.act_zp, a1.a_bit, c1, dot_bf16, plain=plain)
    hq2 = epilogue_gn_swish_quant(dot1, *epi1, tproj, p["norm2"]["scale"], p["norm2"]["bias"], c2.act_scale,
                                  c2.act_zp, a2.a_bit, plain=plain)
    dot2, epi2 = _conv3_dot(hq2, c2.act_zp, a2.a_bit, c2, dot_bf16, plain=plain)

    x_sc = _shortcut(name, p, h_res, rt_i, qunet, qstates, step_idx, plain=plain)
    B, Np = dot2.shape[0], dot2.shape[-1]
    with trace_annotation("adm.exit"):
        if want_exit_stats and Np == co2 and epilogue_residual_gn_stats_fits(dot2.numel() // (B * Np), Np):
            return epilogue_residual_gn_stats(dot2, *epi2, x_sc, out_dtype=res_dtype, plain=plain)
        h = dot2.to(torch.float32)[..., :co2] if dot_bf16 else _epilogue(dot2, c2, co2)
        return (x_sc.to(torch.float32) + h).to(res_dtype), None


def _is_adm(qunet) -> bool:
    """Whether the model served is ADM's (a `QuantizedUNet`'s config says so;
    a stand-in that carries only a policy serves the DDPM's blocks)."""
    cfg = getattr(qunet, "cfg", None)
    return cfg is not None and cfg.model_type == "adm"


def _resample(h, resample):
    """ADM's resampling of a resblock's branch: the 2x2 average pool
    ("down", in float32), nearest x2 ("up", at h's dtype: int8 codes too),
    or h as it is."""
    if resample is None:
        return h
    with trace_annotation("adm.resample"):
        return avg_pool2(h.to(torch.float32)) if resample == "down" else nearest_up2(h)


def _resblock_adm(name, p, h_res, temb_act, rt_i, qunet, res_dtype, *, qstates=None, step_idx=0, dot_bf16=True,
                  resample=None, plain=False):
    """ADM's resblock: norm1 -> swish -> (resample) -> conv1 -> GN(h) * (1 +
    scale) + shift -> swish -> conv2, plus the skip (resampled the same way,
    then the 1x1 `nin_shortcut` where the channels change).  Returns
    (residual', None).

    Every image of a call shares the timestep, so the scale-shift folds
    into norm2's affine once a step: gamma' = gamma (1 + scale), beta' =
    beta (1 + scale) + shift, which K2 / K6 apply with a zero temb add.  An
    upsampling block quantizes at the low resolution (K4) and repeats the
    int8 codes (nearest x2 commutes with the per-channel quantizer); a
    downsampling block pools the swish output in float32 before it
    quantizes (the pool does not commute), its GroupNorm in plain torch.  A
    block off the fold (`fused_block`) runs the unfused chain of the DDPM's
    (plain GroupNorm, `_conv_any`)."""
    cfg = qunet.cfg
    eps = cfg.gn_eps
    c1, c2 = rt_i.get(f"{name}.conv1"), rt_i.get(f"{name}.conv2")
    a1, a2 = qunet.policy[f"{name}.conv1"], qunet.policy[f"{name}.conv2"]
    co1, co2 = p["conv1"]["kernel"].shape[3], p["conv2"]["kernel"].shape[3]
    with trace_annotation("adm.temb"):
        gain, shift = scale_shift(dense(swish(temb_act), p["temb_proj"]).to(torch.float32))
        if gain.shape[0] != 1:
            raise ValueError("ADM serving folds the timestep's scale-shift into norm2 once a call: the batch must "
                             "share one timestep (a stride-0 t, as the samplers pass it)")
        norm2 = {"scale": p["norm2"]["scale"].to(torch.float32) * gain[0],
                 "bias": p["norm2"]["bias"].to(torch.float32) * gain[0] + shift[0]}
    B = h_res.shape[0]

    if not (c1 is not None and c2 is not None and c1.zcbias.shape[-1] == co1):
        with trace_annotation("adm.entry"):
            h = swish(group_norm(h_res.to(torch.float32), p["norm1"], eps=eps))
        h = _conv_any(f"{name}.conv1", _resample(h, resample), p["conv1"], rt_i, qunet, qstates, step_idx,
                      plain=plain)
        with trace_annotation("adm.entry"):
            h = swish(group_norm(h, norm2, eps=eps))
        h = _conv_any(f"{name}.conv2", h, p["conv2"], rt_i, qunet, qstates, step_idx, plain=plain)
        x_sc = _shortcut(name, p, _resample(h_res, resample), rt_i, qunet, qstates, step_idx, plain=plain)
        with trace_annotation("adm.exit"):
            return (x_sc.to(torch.float32) + h).to(res_dtype), None

    q1 = [(c1.act_scale, c1.act_zp, a1.a_bit)]
    if resample == "down":
        with trace_annotation("adm.entry"):
            h = swish(group_norm(h_res.to(torch.float32), p["norm1"], eps=eps))
        h = _resample(h, resample)
        with trace_annotation("adm.entry"):
            hq = _quant_i8(h, *q1[0])
    else:
        (hq,) = _entry_gn_quant(h_res, p["norm1"], q1, eps=eps, plain=plain)
        hq = _resample(hq, resample)
    dot1, epi1 = _conv3_dot(hq, c1.act_zp, a1.a_bit, c1, dot_bf16, plain=plain)
    zero = _identity_of(c1.inv_ws[:co1])[1]
    hq2 = epilogue_gn_swish_quant(dot1, *epi1, zero.expand(B, -1), norm2["scale"], norm2["bias"], c2.act_scale,
                                  c2.act_zp, a2.a_bit, eps=eps, plain=plain)
    dot2, _epi2 = _conv3_dot(hq2, c2.act_zp, a2.a_bit, c2, dot_bf16, plain=plain)
    x_sc = _shortcut(name, p, _resample(h_res, resample), rt_i, qunet, qstates, step_idx, plain=plain)
    with trace_annotation("adm.exit"):
        h = dot2.to(torch.float32)[..., :co2] if dot_bf16 else _epilogue(dot2, c2, co2)
        return (x_sc.to(torch.float32) + h).to(res_dtype), None


def _attn_fused(name, p, h_res, rt_i, qunet, res_dtype, *, attn_int8=True, ar_i=None, qstates=None, step_idx=0,
                plain=False):
    """DDIM single-head attention with int8 q/k/v/proj_out projections.

    Where the map fits JAX's whole-block budget: K3, with `int8_core =
    attn_int8`.  Else the composed branch: one GroupNorm entry
    (`_entry_gn_quant`, no swish: K4 where it takes the map) quantizes
    the normalized tensor at the three projections' scales, the 1x1
    projections are K1 GEMMs to int32, and the core is K9 / K10 at the
    step's calibrated ranges `ar_i` (the quantization at scale absmax / 127
    in plain torch, as XLA fuses it into the projection epilogues), K8
    without them, or with `attn_int8=False` the float32 `head_attention`;
    then proj_out's int8 GEMM, dequant and the residual add.  Where the fold
    does not cover the projections (fewer than 64 channels), JAX's
    fake-quant branch: plain GroupNorm, the four projections as fake-quant
    float convs (`qstates` at `step_idx`) around `head_attention`.

    ADM's blocks (`qunet.cfg.model_type == "adm"`) attend in heads of
    `num_head_channels` at scale d^-1/2 with their GroupNorm's eps: a block
    of more than one head takes the composed branch with the float32 core
    `head_attention` (K11 with heads); one head routes as above."""
    B, H, W, C = h_res.shape
    L = H * W
    adm = _is_adm(qunet)
    heads = heads_of(qunet.cfg, C) if adm else 1
    eps = qunet.cfg.gn_eps if adm else GN_EPS
    scale = (C // heads) ** -0.5
    names = [f"{name}.{k}" for k in ("q", "k", "v", "proj_out")]
    lays = [rt_i.get(n) for n in names]
    pols = [qunet.policy[n] for n in names]
    if any(lay is None for lay in lays):
        with trace_annotation("adm.entry"):
            hf = h_res.to(torch.float32)
            h = group_norm(hf, p["norm"], eps=eps)

        def fq_conv(key, x):
            return _conv_any(f"{name}.{key}", x, p[key], rt_i, qunet, qstates, step_idx, plain=plain)

        q, k, v = (fq_conv(key, h).reshape(B, L, C) for key in ("q", "k", "v"))
        h = head_attention(q, k, v, heads, scale=scale, plain=plain).reshape(B, H, W, C)
        out = fq_conv("proj_out", h)
        with trace_annotation("adm.exit"):
            return (hf + out).to(res_dtype)
    lq, lk, lv, lo = lays
    qp = [(lay.act_scale, lay.act_zp, pol.a_bit) for lay, pol in zip(lays[:3], pols[:3])]
    if heads == 1 and fused_attention_block_fits(L, C) and all(tuple(lay.gq.shape) == (C, C) for lay in lays):
        out = fused_attention_block(
            h_res.to(res_dtype).reshape(B, L, C),
            p["norm"]["scale"], p["norm"]["bias"], qp,
            [(lay.gq, lay.inv_ws, lay.zcbias, lay.gqt) for lay in lays[:3]],
            (lo.act_scale, lo.act_zp, pols[3].a_bit),
            (lo.gq, lo.inv_ws, lo.zcbias, lo.gqt),
            scale=scale, int8_core=bool(attn_int8), eps=eps, plain=plain,
        )
        return out.reshape(B, H, W, C)
    hq, hk, hv = _entry_gn_quant(h_res, p["norm"], qp, act="none", eps=eps, plain=plain)
    if attn_int8 and lq.zcbias.shape[-1] == C:
        dots = [int8_conv(a, lay.gq, 1, gqt=lay.gqt, plain=plain).reshape(B, L, C)
                for a, lay in ((hq, lq), (hk, lk), (hv, lv))]
        if ar_i is not None and all(f"{name}.{k}" in ar_i for k in ("q", "k", "v")):
            with trace_annotation("adm.quant_io"):
                scales = [torch.clamp(ar_i[f"{name}.{k}"], min=1e-12) / torch.full_like(ar_i[f"{name}.{k}"], 127.0)
                          for k in ("q", "k", "v")]
                q8, k8, v8 = (
                    torch.clamp(torch.round((d.to(torch.float32) * lay.inv_ws + lay.zcbias) / sc), -127,
                                127).to(torch.int8)
                    for d, lay, sc in zip(dots, (lq, lk, lv), scales))
            oq = fused_int8_attention_static(q8, k8, v8, *scales, lo.act_scale, lo.act_zp, pols[3].a_bit,
                                             scale=scale, plain=plain)
        else:
            oq = fused_int8_attention(*dots, (lq.inv_ws, lq.zcbias), (lk.inv_ws, lk.zcbias),
                                      (lv.inv_ws, lv.zcbias), lo.act_scale, lo.act_zp, pols[3].a_bit,
                                      scale=scale, plain=plain)
        oq = oq.reshape(B, H, W, C)
    else:
        qkv = []
        for a, lay in ((hq, lq), (hk, lk), (hv, lv)):
            dot = int8_conv(a, lay.gq, 1, gqt=lay.gqt, plain=plain)
            with trace_annotation("adm.quant_io"):
                qkv.append(_epilogue(dot, lay, C).reshape(B, L, C))
        h = head_attention(*qkv, heads, scale=scale, plain=plain).reshape(B, H, W, C)
        with trace_annotation("adm.quant_io"):
            oq = _quant_i8(h, lo.act_scale, lo.act_zp, pols[3].a_bit)
    dot = int8_conv(oq, lo.gq, 1, gqt=lo.gqt, plain=plain)
    with trace_annotation("adm.quant_io"):
        out = _epilogue(dot, lo, C)
    with trace_annotation("adm.exit"):
        return (h_res.to(torch.float32) + out).to(res_dtype)


def _attn_fused_enhanced(name, p, h_res, rt_i, qunet, qstates, step_idx, res_dtype, *, mp_ctx=None, plain=False):
    """The enhanced attention block on the serving path (models/unet.py
    `_attn_apply_enhanced`).  No GroupNorm entry: each 1x1 projection
    quantizes the residual stream at its own policy (the key at
    max(4, b - 2) bits) and runs on K1's 1x1 mode through `_conv_any`
    (the query and key projections' C / 8 outputs padded to 128 columns).
    The core is the FP model's `enhanced_core`: float32 in plain torch, or
    with `mp_ctx` (`mp_states`, `base_bits`, `timestep`) the stage-3
    mixed-precision core (quant/attention_mp.py); the exit is
    `gamma * out + h`."""
    B, H, W, C = h_res.shape
    hf = h_res.to(torch.float32)

    def proj(leaf, x):
        return _conv_any(f"{name}.{leaf}", x, p[leaf], rt_i, qunet, qstates, step_idx, plain=plain)

    q, k, v = (proj(leaf, hf) for leaf in ("query_conv", "key_conv", "value_conv"))
    Ck = q.shape[-1]
    q, k, v = q.reshape(B, H * W, Ck), k.reshape(B, H * W, Ck), v.reshape(B, H * W, C)
    out = enhanced_core(name, q, k.transpose(1, 2), v, qunet.cfg, mp_ctx)
    out = proj("output_conv", out.reshape(B, H, W, C))
    with trace_annotation("adm.exit"):
        return (p["gamma"].to(torch.float32) * out + hf).to(res_dtype)


# ---------------------------------------------------------------------------
# fused forward
# ---------------------------------------------------------------------------


def _require_adm_levers(cfg: UNetConfig, boundary_fusion, resblock_pallas):
    """ADM's resblocks take neither K7's fused exit nor K12 (their norm2 is
    the scale-shift fold's, their entries resample): both levers raise."""
    if cfg.model_type == "adm" and (boundary_fusion or resblock_pallas):
        raise ValueError("ADM serving takes neither boundary_fusion nor resblock_pallas (its resblocks scale-shift "
                         "and resample)")


def _serving_adm_apply(params, cfg: UNetConfig, qunet, rt_i, qstates, x, t, step_idx, res, dot_bf16, plain):
    """ADM's serving forward (models/adm.py's graph): conv_in on the
    fake-quant float conv, every resblock through `_resblock_fused` (its
    `resample` given) and every attention block through `_attn_fused`,
    looked up at call time, then norm_out -> K4 -> conv_out (K1).  The
    batch shares one timestep (the scale-shift fold's): a stride-0 t, as the
    samplers pass it, or one whose entries are all equal (checked here)."""
    t1 = t[:1] if t.ndim == 1 and t.shape[0] > 1 and t.stride(0) == 0 else t
    if t1.ndim == 1 and t1.shape[0] > 1:
        if not bool((t1 == t1[0]).all()):
            raise ValueError("ADM serving folds the timestep's scale-shift into norm2 once a call: the batch must share "
                             "one timestep")
        t1 = t1[:1]
    with trace_annotation("adm.temb"):
        temb = adm_timestep_embedding(t1, cfg.ch)
        temb = dense(swish(dense(temb, params["temb"]["dense0"])), params["temb"]["dense1"])
    h = _conv_any("conv_in", x.to(torch.float32), params["conv_in"], rt_i, qunet, qstates, step_idx,
                  plain=plain).to(res)
    hs = [h]
    for kind, name, _H, _cin, _cout, rs in adm_blocks(cfg):
        part, p = name.split(".")[0], lookup(params, name)
        if kind == "attn":
            with trace_annotation("adm.attn"):
                h = _attn_fused(name, p, h, rt_i, qunet, res, attn_int8=False, qstates=qstates, step_idx=step_idx,
                                plain=plain)
            if part == "down":
                hs[-1] = h
            continue
        if part == "up" and rs is None:
            with trace_annotation("adm.skip"):
                h = torch.cat([h, hs.pop()], dim=-1)
        h, _ = _resblock_fused(name, p, h, temb, rt_i, qunet, res, qstates=qstates, step_idx=step_idx,
                               dot_bf16=dot_bf16, resample=rs, plain=plain)
        if part == "down":
            hs.append(h)
    assert not hs
    return _conv_out(params, cfg, qunet, rt_i, qstates, step_idx, h, plain)


def _conv_out(params, cfg: UNetConfig, qunet, rt_i, qstates, step_idx, h, plain):
    """norm_out -> swish -> conv_out: the entry (K4) and K1's int32 3x3 mode,
    or off the fold the fake-quant float conv."""
    lay = rt_i.get("conv_out")
    if lay is None:
        with trace_annotation("adm.entry"):
            h = swish(group_norm(h.to(torch.float32), params["norm_out"], eps=cfg.gn_eps))
        return _conv_any("conv_out", h, params["conv_out"], rt_i, qunet, qstates, step_idx,
                         plain=plain).to(torch.float32)
    a_bit = qunet.policy["conv_out"].a_bit
    (hq,) = _entry_gn_quant(h, params["norm_out"], [(lay.act_scale, lay.act_zp, a_bit)], eps=cfg.gn_eps, plain=plain)
    dot = int8_conv3_qzero(hq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
    with trace_annotation("adm.quant_io"):
        return _epilogue(dot, lay, cfg.out_ch).to(torch.float32)


@exact_f32()
def serving_unet_apply(params, cfg: UNetConfig, qunet: QuantizedUNet,
                       runtime: Dict[str, ServingLayer], qstates: Dict[str, ActQuantState],
                       x: torch.Tensor, t: torch.Tensor, step_idx: int, *,
                       residual_dtype=torch.float32, attn_int8=None, attn_ranges=None,
                       boundary_fusion: bool = False, dot_bf16: bool = True,
                       entry_pallas: bool = False, conv_pallas=False, resblock_pallas=False,
                       mp_states=None, mp_base_bits: int = 8, plain=False) -> torch.Tensor:
    """Fused int8-resident forward (eps, float32).  Mirrors
    models/unet.unet_apply at inference.

    `residual_dtype` (float32, JAX's default, or bfloat16) is the stream
    between blocks.  `dot_bf16` (default True) fuses each resblock conv's
    dequant into K1 and hands K2 / K6 / K7 bf16; False hands them K1's int32
    accumulator.  `conv_pallas` takes JAX's values and changes nothing here
    (every int8 conv is K1 already).

    Every resblock, conv_out and composed attention entry runs on K4
    wherever `gn_act_quant_takes` admits its shape.  `entry_pallas` (True or
    False), the lever that on the TPU sent the entries within a VMEM budget
    through the Pallas kernel, takes JAX's values and, as `conv_pallas`,
    changes nothing here.  The two other levers, each routed by JAX's
    predicates: `boundary_fusion` fuses a resblock exit with the next block's GroupNorm
    statistics (K7) where that block's norm1 reads exactly the exit's
    tensor; `resblock_pallas` (True: where JAX's conv policy says so; "all":
    wherever it fits) runs identity-residual blocks as K12.

    `attn_int8` (None: the variant's own, True on the ddim block as JAX's
    default) runs the attention logits as int8 products: K3's int8 core
    where the whole-block kernel takes the map, K8 on larger maps, or K9 /
    K10 where `attn_ranges` ({proj_name: [S]} from
    `calibrate_ranges(return_attn_ranges=True)`) has the site's q, k and v.

    The enhanced attention variant (`_attn_fused_enhanced`) takes
    `attn_int8` None or False and no `attn_ranges` (its core is float32), and
    `mp_states` ({layer name: MPAttentionState}, stage 3) swaps its core for
    the mixed-precision one at `mp_base_bits`, at the timestep `t[0]` (the
    diffusion timestep, kept on the device).

    `t` [B]: the batch's timesteps; one timestep expanded over the batch
    (stride 0) computes its embedding once.  `plain=True` runs the kernels'
    plain versions instead, on any device (for comparisons)."""
    _check_flags(residual_dtype=residual_dtype, dot_bf16=dot_bf16, entry_pallas=entry_pallas,
                 conv_pallas=conv_pallas, resblock_pallas=resblock_pallas)
    check_ported(cfg)
    attn_int8 = _require_attention_flags(cfg, attn_int8, attn_ranges, mp_states)
    _require_adm_levers(cfg, boundary_fusion, resblock_pallas)
    with trace_annotation("adm.views"):
        rt_i = gather_step(runtime, step_idx)
        ar_i = None if attn_ranges is None else {k: a[step_idx] for k, a in attn_ranges.items()}
    res = residual_dtype
    if cfg.model_type == "adm":
        return _serving_adm_apply(params, cfg, qunet, rt_i, qstates, x, t, step_idx, res, dot_bf16, plain)
    if cfg.attn_variant == "enhanced":
        mp_ctx = None
        if mp_states:
            mp_ctx = dict(mp_states=mp_states, base_bits=mp_base_bits, timestep=t.reshape(-1)[0].to(torch.int64))

        def attn_site(nm, pp, hh):
            with trace_annotation("adm.attn"):
                return _attn_fused_enhanced(nm, pp, hh, rt_i, qunet, qstates, step_idx, res, mp_ctx=mp_ctx,
                                            plain=plain)
    else:
        def attn_site(nm, pp, hh):
            with trace_annotation("adm.attn"):
                return _attn_fused(nm, pp, hh, rt_i, qunet, res, attn_int8=attn_int8, ar_i=ar_i, qstates=qstates,
                                   step_idx=step_idx, plain=plain)
    num_levels = len(cfg.ch_mult)
    levers = dict(qstates=qstates, step_idx=step_idx, dot_bf16=dot_bf16, resblock_pallas=resblock_pallas,
                  plain=plain)

    def conv_site(nm, h, **kw):
        return _conv_any(nm, h, lookup(params, nm), rt_i, qunet, qstates, step_idx, plain=plain, **kw)

    # a timestep shared by the batch (a stride-0 t, as the sampler passes it) takes the time embedding and
    # the resblocks' projections of its one row: the same bits at any batch size (a [B, C] matmul's rounding
    # depends on B), so micro-batches give the whole batch's output
    t1 = t[:1] if t.ndim == 1 and t.shape[0] > 1 and t.stride(0) == 0 else t
    with trace_annotation("adm.temb"):
        temb = get_timestep_embedding(t1, cfg.ch)
        temb = dense(swish(dense(temb, params["temb"]["dense0"])), params["temb"]["dense1"])

    hs = [conv_site("conv_in", x.to(torch.float32)).to(res)]
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
                h = attn_site(f"down.{i_level}.attn.{i_block}", lp["attn"][i_block], h)
                sums = None
            hs.append(h)
        if i_level != num_levels - 1:
            sums = None
            nm = f"down.{i_level}.downsample.conv"
            lay = rt_i.get(nm)
            if not cfg.resamp_with_conv:
                hd = avg_pool2(hs[-1].to(torch.float32))
            elif lay is not None:
                # int8 stride-2 downsample (asymmetric quantized-zero pad)
                a_bit = qunet.policy[nm].a_bit
                with trace_annotation("adm.quant_io"):
                    xq = _quant_i8(hs[-1].to(torch.float32), lay.act_scale, lay.act_zp, a_bit)
                dot = int8_conv3_qzero_down(xq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
                with trace_annotation("adm.quant_io"):
                    hd = _epilogue(dot, lay, lookup(params, nm)["kernel"].shape[3]).to(res)
            else:  # off the fold: the (0, 1) zero pad, then the fake-quant stride-2 conv, as the FP graph
                with trace_annotation("adm.halo"):
                    hd = F.pad(hs[-1], (0, 0, 0, 1, 0, 1))
                hd = conv_site(nm, hd, stride=2, padding="VALID")
            hs.append(hd.to(res))

    h = hs[-1]
    h, _ = _resblock_fused("mid.block_1", params["mid"]["block_1"], h, temb, rt_i, qunet, res,
                           entry_sums=sums, **levers)
    h = attn_site("mid.attn_1", params["mid"]["attn_1"], h)
    h, _ = _resblock_fused("mid.block_2", params["mid"]["block_2"], h, temb, rt_i, qunet, res, **levers)

    for i_level in reversed(range(num_levels)):
        lp = params["up"][i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            with trace_annotation("adm.skip"):
                h = torch.cat([h, hs.pop()], dim=-1)
            h, _ = _resblock_fused(f"up.{i_level}.block.{i_block}", lp["block"][i_block], h, temb, rt_i, qunet, res,
                                   **levers)
            if lp["attn"]:
                h = attn_site(f"up.{i_level}.attn.{i_block}", lp["attn"][i_block], h)
        if i_level != 0:
            nm = f"up.{i_level}.upsample.conv"
            lay = rt_i.get(nm) if cfg.resamp_with_conv else None
            if lay is not None:
                # int8-domain nearest upsample: quantize at low resolution, then
                # repeat the int8 entries (nearest resize commutes exactly with
                # per-channel quantization)
                a_bit = qunet.policy[nm].a_bit
                with trace_annotation("adm.quant_io"):
                    xq = nearest_up2(_quant_i8(h.to(torch.float32), lay.act_scale, lay.act_zp, a_bit))
                dot = int8_conv3_qzero(xq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt, plain=plain)
                with trace_annotation("adm.quant_io"):
                    h = _epilogue(dot, lay, lookup(params, nm)["kernel"].shape[3]).to(res)
            else:
                h = nearest_up2(h)
                if cfg.resamp_with_conv:
                    h = conv_site(nm, h).to(res)
    assert not hs
    return _conv_out(params, cfg, qunet, rt_i, qstates, step_idx, h, plain)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def _slice_states(qstates: Dict[str, ActQuantState], sl: slice) -> Dict[str, ActQuantState]:
    return {k: ActQuantState(**{f.name: getattr(v, f.name)[sl] for f in dataclasses.fields(v)})
            for k, v in qstates.items()}


def _stream_generators(generator, n_mb: int):
    """One generator per micro-batch, as JAX's `fold_in(key, i)` gives each
    micro-batch its own stream: the caller's generator where there is one
    micro-batch, else generators seeded from draws of it."""
    if n_mb == 1:
        return [generator]
    seeds = torch.randint(0, 2 ** 62, (n_mb,), generator=generator, device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s) for s in seeds]


def serving_ddim_sampler(qunet: QuantizedUNet, params, qstates: Dict[str, ActQuantState], seq,
                         betas: torch.Tensor, *, eta: float = 0.0, step_chunk=None,
                         micro_batch=None, residual_dtype=torch.float32, symmetric: bool = True,
                         attn_int8=None, attn_ranges=None, weight_extras=None,
                         boundary_fusion: bool = False, dot_bf16: bool = True,
                         entry_pallas: bool = False, conv_pallas=False, resblock_pallas=False,
                         pack_int4: bool = False, rank1: bool = False, update: str = "ddim",
                         mp_states=None, mp_base_bits: int = 8, runtime=None, plain: bool = False):
    """Sampler over the fused int8 serving path: folds every step's weights
    once (or reuses a prebuilt `runtime`), then returns
    ``sample(x, generator=None, noise=None) -> x_final``.

    `update` selects the per-step rule: "ddim" (generalized, noised at
    `eta` > 0) or "ddpm" (ancestral, always noised; `eta` is ignored).  The
    eps model, the folds, chunking and rank-1 folds are the same for both.
    A stochastic sampler draws step i's noise from `generator` (a
    `torch.Generator`; None: one seeded 0 on x's device, as JAX's default
    key is `PRNGKey(0)`), or takes it from `noise` ([S, N, H, W, C] or a list
    of S tensors: the draws themselves, e.g. JAX's).

    `runtime`: a prebuilt `prepare_serving_runtime` tree to reuse; samplers
    that differ only in compute-path flags (`attn_int8`, `attn_ranges`,
    `entry_pallas`, `boundary_fusion`, `resblock_pallas`; see
    `serving_unet_apply`) share one fold instead of holding a copy each.

    `pack_int4` / `rank1`: the fold's forms (`prepare_serving_runtime`).
    `step_chunk=k` folds k steps at a time inside `sample`, so the fold holds
    k steps instead of all; `micro_batch=m` then advances the batch through
    each chunk m images at a time, so one chunk's fold serves the whole
    batch.  Both give the unchunked sampler's output to the bit at eta = 0
    (the fold's shrink is the whole schedule's, `_fold_all_steps`).  A noised
    sampler gives each micro-batch its own stream (`_stream_generators`,
    carried across the chunks; `noise` is sliced along N), so it matches the
    un-micro-batched one only at eta = 0 with the ddim update, as in JAX.
    As in JAX, `rank1` and a prebuilt `runtime` refuse `step_chunk`; unlike
    JAX, which ignores it there, `micro_batch` without `step_chunk` raises too.

    `weight_extras` {name: quant.adaround.WeightExtras} go into every fold,
    a chunk's too (its [S, co] refinements' rows of the chunk).

    `mp_states` / `mp_base_bits`: the enhanced variant's stage-3 core
    (`serving_unet_apply`).  The states are indexed by the diffusion
    timestep, not the step, so a chunk takes them whole.  `plain=True` runs
    every kernel's plain version instead (the other side of a check)."""
    _check_update(update)
    _check_flags(residual_dtype=residual_dtype, dot_bf16=dot_bf16, entry_pallas=entry_pallas,
                 conv_pallas=conv_pallas, resblock_pallas=resblock_pallas)
    _require_symmetric(symmetric)
    attn_int8 = _require_attention_flags(qunet.cfg, attn_int8, attn_ranges, mp_states)
    _require_adm_levers(qunet.cfg, boundary_fusion, resblock_pallas)
    if runtime is not None and step_chunk is not None:
        raise ValueError("a prebuilt runtime holds all steps' folds: incompatible with step_chunk's per-chunk folds")
    if rank1 and step_chunk is not None:
        raise ValueError("rank1 shared folds make step_chunk unnecessary (the fold is params-sized at any "
                         "schedule length): drop one of the two")
    if micro_batch is not None and step_chunk is None:
        raise ValueError("micro_batch advances the batch through each chunk of step_chunk: it needs step_chunk")
    t_rev, _, at, at_next = _seq_alphas(betas, seq)
    S = t_rev.shape[0]
    noised = update == "ddpm" or eta > 0

    def fold(steps=None):
        return prepare_serving_runtime(qunet, params, qstates, symmetric=symmetric, steps=steps,
                                       weight_extras=weight_extras, pack_int4=pack_int4, rank1=rank1)

    if runtime is None and step_chunk is None:
        runtime = fold()
    flags = dict(residual_dtype=residual_dtype, attn_int8=attn_int8, boundary_fusion=boundary_fusion,
                 dot_bf16=dot_bf16, entry_pallas=entry_pallas, conv_pallas=conv_pallas,
                 resblock_pallas=resblock_pallas, mp_states=mp_states, mp_base_bits=mp_base_bits, plain=plain)

    def run(x, rt, qs, ar, lo, hi, gen, noise):
        """Steps lo .. hi - 1 of the schedule, with the fold `rt` and states `qs` of those steps."""
        n, rule = x.shape[0], step_rule(update, eta, gen, noise)
        for i in range(lo, hi):
            with trace_annotation("adm.step"):
                et = serving_unet_apply(params, qunet.cfg, qunet, rt, qs, x, t_rev[i].to(torch.float32).expand(n),
                                        i - lo, attn_ranges=ar, **flags)
                with trace_annotation("adm.update"):
                    x, _ = rule(i, x, et, t_rev[i], at[i], at_next[i])
        return x

    def sample(x, generator=None, noise=None):
        with trace_annotation("adm.sample"):
            mb = micro_batch or x.shape[0]
            xs = list(x.split(mb))
            for n in sorted({xi.shape[0] for xi in xs}):
                require_gn_kernels(qunet.cfg, x.device, n, residual_dtype=residual_dtype, dot_bf16=dot_bf16,
                                   entry_pallas=entry_pallas, boundary_fusion=boundary_fusion,
                                   resblock_pallas=resblock_pallas)
            require_attention_kernels(qunet.cfg, x.device, attn_int8=attn_int8, attn_ranges=attn_ranges)
            gens = [None] * len(xs)
            if noised and noise is None:
                gens = _stream_generators(generator or torch.Generator(device=x.device).manual_seed(0), len(xs))
            noises = [None] * len(xs)
            if noise is not None:
                noises = [[noise[i][j * mb:(j + 1) * mb] for i in range(S)] for j in range(len(xs))]
            if step_chunk is None:
                return run(x, runtime, qstates, attn_ranges, 0, S, gens[0], noises[0])
            for c0 in range(0, S, step_chunk):
                sl = slice(c0, min(c0 + step_chunk, S))
                rt = fold(sl)
                qs = _slice_states(qstates, sl)
                ar = None if attn_ranges is None else {k: a[sl] for k, a in attn_ranges.items()}
                for j, xj in enumerate(xs):
                    xs[j] = run(xj, rt, qs, ar, sl.start, sl.stop, gens[j], noises[j])
                del rt
            return torch.cat(xs)

    sample.runtime = runtime
    return sample


def serving_model_fn(qunet: QuantizedUNet, runtime: Dict[str, ServingLayer], params,
                     qstates: Dict[str, ActQuantState], **flags):
    """Sampler-compatible `(x, t, step_idx) -> eps` closure over the serving
    forward on RAW params; `flags` are `serving_unet_apply`'s keywords."""

    def fn(x, t, step_idx):
        return serving_unet_apply(params, qunet.cfg, qunet, runtime, qstates, x, t, step_idx, **flags)

    return fn
