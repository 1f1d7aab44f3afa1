"""The fused GroupNorm kernels of the serving resblock (port of
`attentiondm_tpu/ops/fused_gn.py`): K4 `gn_act_quant` (the entry), K2 and
K6 `epilogue_gn_swish_quant` / `_blocked` (conv1 epilogue -> +temb ->
GroupNorm -> swish -> int8 quant) and K7 `epilogue_residual_gn_stats` (the
exit plus the next entry's statistics).

K4 (csrc/gn_act_quant.cu): GroupNorm -> swish or none -> one to three int8
quantizations of the same normalized tensor, one block per image.  K7
(csrc/epilogue_residual_gn_stats.cu): residual' = x_res + dequant(dot) and
the per-(image, group) sums [B, 2, G] of the f32 residual', which
`gn_finalize_sums` turns into the next GroupNorm's mean and rstd.

K2 and K6: one pass from conv1's output (bf16 already dequantized, or the int32
accumulator with `inv_ws` / `zcbias`) to conv2's int8 input; the float32
intermediate never reaches device memory.  `epilogue_gn_swish_quant`
routes by JAX's own predicate: images within the TPU kernel's whole-image
budget take K2 (`epilogue_gn_swish_quant_whole`, csrc/fused_gn.cu, a
cluster of blocks per image), larger ones on the 128-channel grid take K6
(`epilogue_gn_swish_quant_blocked`, csrc/fused_gn_blocked.cu, one launch
over chunks of 1024 rows), and the rest raise.  Both launch as
`epilogue_plan` says (csrc/gn_epilogue.cuh).

GroupNorm statistics follow the TPU kernel's `_gn_normalize`: per-group
sum and sum of squares in float32, variance E[x^2] - mu^2 clamped at 0
(not torch's two-pass `var`).  The float32 sums run in one fixed order,
`window_sum`'s, in the kernels and here alike, so kernel and plain version
give the same bits (csrc/common.cuh).  Swish is written
`h * (1 / (1 + exp(-h)))`, the kernel's formula.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..quant.primitives import div
from . import _build

GROUPS = 32  # the UNet's GroupNorm (eps 1e-6)
WIN = 32  # rows per window of the float32 sums (csrc/common.cuh GN_WIN)
CHUNK = WIN * WIN  # rows per K6 block (GN_CHUNK)
WHOLE_IMAGE_BYTES = 4 * 1024 * 1024  # JAX's whole-image budget for K2: HW * N * (in bytes + 1)
_ROADMAP = "ROADMAP Queue 1, 'the enhanced variant and the remaining serving flags'"


def _seq_sum(x, dim: int):
    """Sum along `dim` in index order, one float32 add at a time."""
    x = x.movedim(dim, 0)
    s = x[0]
    for i in range(1, x.shape[0]):
        s = s + x[i]
    return s


def window_sum(x):
    """[..., n, C] -> [..., C] float32 sum over rows in the windowed order
    of XLA's CPU reduction: windows of 32 consecutive rows summed in
    sequence, then the window sums the same way, until at most 32 remain,
    which add in sequence.  The kernels sum in this order (csrc/common.cuh)."""
    while x.shape[-2] > WIN:
        n = x.shape[-2]
        m = -(-n // WIN)
        x = F.pad(x, (0, 0, 0, m * WIN - n))
        x = _seq_sum(x.reshape(*x.shape[:-2], m, WIN, x.shape[-1]), -2)
    return _seq_sum(x, -2)


def _finalize(s_g, s2_g, inv_count: float):
    mean_g = s_g * inv_count
    var_g = torch.clamp(s2_g * inv_count - mean_g * mean_g, min=0.0)
    return mean_g, div(1.0, torch.sqrt(var_g + 1e-6))


def _normalize(x, mean_g, rstd_g, gn_scale, gn_bias):
    cg = x.shape[-1] // mean_g.shape[-1]
    mean_c = mean_g.repeat_interleave(cg, dim=-1)[:, None, :]
    rstd_c = rstd_g.repeat_interleave(cg, dim=-1)[:, None, :]
    return (x - mean_c) * rstd_c * gn_scale + gn_bias


def gn_normalize(x, gn_scale, gn_bias):
    """x [B, HW, C] float32 -> GroupNorm(x) with E[x^2]-mu^2 statistics,
    summed per channel by `window_sum`, then per group in channel order."""
    B, HW, C = x.shape
    g = min(GROUPS, C)
    cg = C // g
    s_g = _seq_sum(window_sum(x).reshape(B, g, cg), -1)
    s2_g = _seq_sum(window_sum(x * x).reshape(B, g, cg), -1)
    mean_g, rstd_g = _finalize(s_g, s2_g, 1.0 / (HW * cg))
    return _normalize(x, mean_g, rstd_g, gn_scale, gn_bias)


def swish(h):
    return h * div(1.0, 1.0 + torch.exp(-h))


def quant_i8(x, scale, zp, a_bit: int):
    n = 2 ** (a_bit - 1)
    return torch.clamp(torch.round(scale * x - zp), -n, n - 1).to(torch.int8)


def _epilogue_h(dot, inv_ws, zcbias, temb):
    B, N = dot.shape[0], dot.shape[-1]
    h = dot.to(torch.float32).reshape(B, -1, N) * inv_ws + zcbias
    return h + temb.to(torch.float32)[:, None, :]


def epilogue_gn_swish_quant_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                act_zp, a_bit: int):
    """Plain version of K2."""
    h = gn_normalize(_epilogue_h(dot, inv_ws, zcbias, temb), gn_scale.float(), gn_bias.float())
    return quant_i8(swish(h), act_scale, act_zp, a_bit).reshape(dot.shape)


def epilogue_gn_swish_quant_blocked_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                        act_zp, a_bit: int):
    """Plain version of K6, in its order: per chunk of CHUNK rows the
    channel sums (`window_sum`) and their group sums, then the chunks' group
    sums in chunk order."""
    h = _epilogue_h(dot, inv_ws, zcbias, temb)
    B, HW, N = h.shape
    g = min(GROUPS, N)
    cg = N // g
    nchunk = -(-HW // CHUNK)
    hc = F.pad(h, (0, 0, 0, nchunk * CHUNK - HW)).reshape(B, nchunk, CHUNK, N)
    s_g = _seq_sum(_seq_sum(window_sum(hc).reshape(B, nchunk, g, cg), -1), 1)
    s2_g = _seq_sum(_seq_sum(window_sum(hc * hc).reshape(B, nchunk, g, cg), -1), 1)
    mean_g, rstd_g = _finalize(s_g, s2_g, 1.0 / (HW * cg))
    h = _normalize(h, mean_g, rstd_g, gn_scale.float(), gn_bias.float())
    return quant_i8(swish(h), act_scale, act_zp, a_bit).reshape(dot.shape)


def epilogue_route(shape, dtype) -> str:
    """Which kernel takes a conv1 output of this shape: "K2" or "K6", by the
    JAX dispatcher's predicate (`attentiondm_tpu/ops/fused_gn.py`
    epilogue_gn_swish_quant).  Shapes JAX sends to its XLA reference raise."""
    N = shape[-1]
    HW = 1
    for d in shape[1:-1]:
        HW *= d
    itemsize = torch.empty((), dtype=dtype).element_size()
    if HW * N * (itemsize + 1) <= WHOLE_IMAGE_BYTES:
        return "K2"
    if N % 128 == 0 and HW % 8 == 0:
        return "K6"
    raise NotImplementedError(
        f"epilogue_gn_swish_quant: HW={HW}, N={N} is over the whole-image budget and off the blocked "
        f"kernel's grid (N % 128, HW % 8), where JAX runs its XLA reference; not ported ({_ROADMAP})")


# The launch plan of K2 and K6 (csrc/gn_epilogue.cuh), computed here and
# handed to the C entry points, which refuse any other.
SMS = 132  # the H100 SXM's streaming multiprocessors
SMEM_MAX = 232448  # dynamic shared memory a Hopper block can have
# a wave: 16 warps on 128 of the SMs.  K2 is bound by its f32 work (~45 instructions an element), so more
# blocks than that only add per-block cost (PERF.md)
WAVE_THREADS = 128 * 512
HOLD_MAX = 64 * 1024  # a larger held slab leaves too few warps on its SM (PERF.md)
CLUSTERS = (1, 2, 4, 8, 16)  # 16 is a non-portable cluster size; the H100 takes it
VEC = 8  # channels a thread owns: 16 bytes of bf16, two 16-byte loads of int32
MAX_THREADS = 512  # the kernels' launch bound (up to 128 registers: 8 channels' constants)
K6_THREADS = 128  # four K6 blocks an SM: one's apply pass runs beside the others' first reads


def _k2_smem(wpb: int, N: int, itemsize: int, threads: int, held: bool) -> int:
    """csrc/gn_epilogue.cuh k2_layout: the held slab, the published sums
    (one [2, N] node per window, or per chunk when a block owns whole
    chunks), the round buffer and chunk sums of chunk mode, the image's
    channel totals and one mbarrier per held window."""
    chunks = wpb >= WIN
    slab = wpb * WIN * N * itemsize if held else 0
    nodes = wpb // WIN if chunks else wpb
    rounds = 4 * 2 * N * (threads // (N // VEC) + 1) if chunks else 0
    return slab + 4 * 2 * N * nodes + rounds + 4 * 2 * N + (8 * wpb if held else 0)


@functools.lru_cache(maxsize=None)  # the wrappers ask once a call; a plan is a few dozen Python operations
def epilogue_plan(B: int, HW: int, N: int, dtype, kind: str) -> dict:
    """How K2 ("K2") or K6 ("K6") spreads one call over the card.

    K2: a thread-block cluster of `cluster` blocks per image, each owning
    `wpb` consecutive 32-row windows (`rows` = 32 * wpb rows; the image's last
    block may own fewer).  Below 32 windows a block publishes each window's
    channel sums, from 32 up it owns whole 1024-row chunks and publishes their
    sums; each block of the cluster adds up a share of the channels in
    `window_sum`'s order and hands the totals to every block.  `held`:
    the block copies its slab into shared memory once and the apply pass reads
    it there (one HBM read); otherwise the apply pass re-reads it from L2.
    The cluster size is the smallest whose blocks hold WAVE_THREADS threads
    in all (else the largest the image's windows allow); the slab is held
    where it takes at most HOLD_MAX bytes.

    K6: a persistent grid of resident blocks that take (image, chunk) items
    of CHUNK rows in image-major order (`blocks_per_image` = chunks per
    image); an image's chunks must all be in flight at once, so it takes at
    most `SMS` chunks.

    Raises NotImplementedError for a shape the kernels do not take."""
    if dtype not in (torch.bfloat16, torch.int32):
        raise NotImplementedError(f"epilogue_plan: {dtype} (K2 and K6 take bf16 or int32)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    g = min(GROUPS, N)
    V = N // VEC
    if N % VEC or N % g or N > 1024 or HW < 1:
        raise NotImplementedError(f"epilogue_plan: N={N}, HW={HW} (N a multiple of {VEC} and of its groups, "
                                  f"up to 1024)")
    if kind == "K6":
        nchunk = -(-HW // CHUNK)
        if N % 128 or nchunk > SMS:
            raise NotImplementedError(f"epilogue_plan: K6 at N={N}, HW={HW} (N a multiple of 128, at most "
                                      f"{SMS} chunks of {CHUNK} rows an image)")
        threads = min(WIN, K6_THREADS // V) * V
        return dict(kind="K6", blocks_per_image=nchunk, rows=CHUNK, threads=threads,
                    smem=4 * 2 * N * (threads // V + 1))
    if kind != "K2":
        raise ValueError(f"epilogue_plan: kind={kind!r}")
    plans = k2_plans(HW, N, itemsize)
    if not plans:
        raise NotImplementedError(f"epilogue_plan: K2 at HW={HW}, N={N} (at most {WIN * WIN * CHUNK} rows, "
                                  f"and what a block's shared memory holds)")

    def rank(p):  # a wave of threads, then the fewest blocks (else the most), then a held slab up to HOLD_MAX
        wave = B * p["cluster"] * p["threads"] >= WAVE_THREADS
        held = p["held"] and p["wpb"] * WIN * N * itemsize <= HOLD_MAX
        return (not wave, p["cluster"] if wave else -p["cluster"], not held, p["held"])

    return min(plans, key=rank)


def k2_plans(HW: int, N: int, itemsize: int) -> list:
    """Every K2 launch plan for an image of HW rows and N channels of
    `itemsize` bytes that the kernel takes: per cluster size, a block's
    windows and threads, with the slab held in shared memory and without
    (where each fits)."""
    if HW > WIN * WIN * CHUNK or N % VEC or N > 1024:
        return []
    V = N // VEC
    nwin = -(-HW // WIN)
    plans = []
    for cl in CLUSTERS:
        wpb = -(-nwin // cl)
        if wpb > WIN:
            wpb = -(-wpb // WIN) * WIN
        cl = -(-nwin // wpb)
        if any(p["cluster"] == cl for p in plans):
            continue
        if wpb >= WIN:
            threads = min(WIN, MAX_THREADS // V) * V
        else:
            threads = max(V, min(MAX_THREADS, max(256, V * wpb)) // V * V)
        for held in ((True, False) if wpb < WIN else (False,)):
            smem = _k2_smem(wpb, N, itemsize, threads, held)
            if smem <= SMEM_MAX:
                plans.append(dict(kind="K2", cluster=cl, wpb=wpb, rows=wpb * WIN, threads=threads, smem=smem,
                                  held=held))
    return plans


def _vectors(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp):
    vecs = [v.to(torch.float32).contiguous() for v in (inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp)]
    dot = dot.contiguous()
    return dot, vecs


def epilogue_gn_swish_quant(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                            a_bit: int, *, plain: bool = False):
    """dot [B, H, W, N] (bf16 or int32) -> int8 [B, H, W, N] input of the next
    conv; temb [B, N] is the time-embedding projection added before the
    statistics.  Routes to K2 or K6 (`epilogue_route`); `plain=True` runs
    the chosen kernel's plain version on any device."""
    if dot.dtype not in (torch.bfloat16, torch.int32):
        raise NotImplementedError(f"epilogue_gn_swish_quant: dot dtype {dot.dtype}")
    kernel = {"K2": epilogue_gn_swish_quant_whole, "K6": epilogue_gn_swish_quant_blocked}
    return kernel[epilogue_route(dot.shape, dot.dtype)](dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                                         act_zp, a_bit, plain=plain)


def epilogue_gn_swish_quant_whole(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                                  a_bit: int, *, plain: bool = False):
    """K2: `epilogue_gn_swish_quant`, a cluster of blocks per image
    (`epilogue_plan(..., "K2")`), at any shape the plan takes (N a multiple of
    8 up to 1024, HW up to 32 * 32 * CHUNK rows as shared memory allows).
    The serving path reaches it through the router; called directly it also
    runs at K6's shapes, for comparing the two.  `plain=True` runs the plain
    version on any device."""
    args = (dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp, a_bit)
    if plain or dot.device.type == "cpu":
        return epilogue_gn_swish_quant_ref(*args)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    g = min(GROUPS, N)
    plan = epilogue_plan(B, HW, N, dot.dtype, "K2")
    dot, vecs = _vectors(*args[:-1])
    _build.require_cuda("epilogue_gn_swish_quant_whole", dot, *vecs)
    out = torch.empty(dot.shape, dtype=torch.int8, device=dot.device)
    err = _build.kernels().adm_epilogue_gn_swish_quant(
        dot.data_ptr(), int(dot.dtype == torch.int32), *(v.data_ptr() for v in vecs), out.data_ptr(),
        B, HW, N, g, 2 ** (a_bit - 1), 1.0 / (HW * (N // g)),
        *(int(plan[k]) for k in ("cluster", "wpb", "threads", "smem", "held")), _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_gn_swish_quant")
    epilogue_gn_swish_quant_whole.launches += 1
    return out


epilogue_gn_swish_quant_whole.launches = 0


def epilogue_gn_swish_quant_blocked(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                                    a_bit: int, *, plain: bool = False):
    """K6: `epilogue_gn_swish_quant` for images over the whole-image budget
    (N a multiple of 128): one launch of resident blocks over (image, chunk
    of CHUNK rows) items (`epilogue_plan(..., "K6")`).  `plain=True` runs the
    plain version on any device."""
    if plain or dot.device.type == "cpu":
        return epilogue_gn_swish_quant_blocked_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias,
                                                   act_scale, act_zp, a_bit)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    plan = epilogue_plan(B, HW, N, dot.dtype, "K6")
    g = min(GROUPS, N)
    dot, vecs = _vectors(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp)
    _build.require_cuda("epilogue_gn_swish_quant_blocked", dot, *vecs)
    partial = torch.empty((B, plan["blocks_per_image"], 2, g), dtype=torch.float32, device=dot.device)
    flags = torch.zeros(B + 1, dtype=torch.int32, device=dot.device)  # the item counter, then each image's arrivals
    out = torch.empty(dot.shape, dtype=torch.int8, device=dot.device)
    err = _build.kernels().adm_epilogue_gn_swish_quant_blocked(
        dot.data_ptr(), int(dot.dtype == torch.int32), *(v.data_ptr() for v in vecs), partial.data_ptr(),
        flags.data_ptr(), out.data_ptr(), B, HW, N, g, 2 ** (a_bit - 1), 1.0 / (HW * (N // g)), plan["threads"],
        plan["smem"], _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_gn_swish_quant_blocked")
    epilogue_gn_swish_quant_blocked.launches += 1
    return out


epilogue_gn_swish_quant_blocked.launches = 0


# ---------------------------------------------------------------------------
# K4: GroupNorm -> swish or none -> n_out int8 quantizations
# ---------------------------------------------------------------------------


def gn_act_quant_fits(HW: int, C: int) -> bool:
    """JAX's predicate for the one-pass entry kernel (a whole f32 image and
    its int8 output within 4 MiB); callers that route the entry
    (`quant/int8_serving._entry_gn_quant`) gate on it."""
    return HW * C * 5 <= WHOLE_IMAGE_BYTES


def gn_act_quant_ref(x, gn_scale, gn_bias, quant_params, *, act: str = "swish"):
    """Plain version of K4."""
    B, C = x.shape[0], x.shape[-1]
    h = gn_normalize(x.to(torch.float32).reshape(B, -1, C), gn_scale.float(), gn_bias.float())
    if act == "swish":
        h = swish(h)
    return tuple(quant_i8(h, s, z, b).reshape(x.shape) for (s, z, b) in quant_params)


def gn_act_quant(x, gn_scale, gn_bias, quant_params, *, groups: int = GROUPS, act: str = "swish",
                 plain: bool = False):
    """K4: x [B, H, W, C] or [B, HW, C] (bf16 or f32) -> a tuple of int8
    tensors of x's shape, one per (act_scale [C], act_zp [C], a_bit) of
    `quant_params` (1 to 3), each the quantized GroupNorm(x) after `act`
    ("swish" or "none").  `plain=True` runs the plain version on any device."""
    if act not in ("swish", "none"):
        raise ValueError(f"gn_act_quant: act={act!r}")
    if groups != GROUPS:
        raise NotImplementedError(f"gn_act_quant: groups={groups} (the UNet's GroupNorm has {GROUPS})")
    if plain or x.device.type == "cpu":
        return gn_act_quant_ref(x, gn_scale, gn_bias, quant_params, act=act)
    B, C = x.shape[0], x.shape[-1]
    HW = x.numel() // (B * C)
    g = min(GROUPS, C)
    n_out = len(quant_params)
    if (x.dtype not in (torch.bfloat16, torch.float32) or C % g or C > 1024 or not 1 <= n_out <= 3
            or HW > WIN * WIN * CHUNK):
        raise NotImplementedError(
            f"gn_act_quant: {x.dtype}, C={C}, HW={HW}, {n_out} outputs (K4 takes bf16 or f32, C up to "
            f"1024, HW <= {WIN * WIN * CHUNK}, 1 to 3 outputs)")
    x = x.contiguous()
    vecs = [_build.f32c(v, x.device) for v in (gn_scale, gn_bias)]
    vecs += [_build.f32c(v, x.device) for (s, z, _b) in quant_params for v in (s, z)]
    _build.require_cuda("gn_act_quant", x, *vecs)
    if any(v.numel() != C for v in vecs):
        raise ValueError(f"gn_act_quant: per-channel vectors must hold {C} values")
    outs = [torch.empty(x.shape, dtype=torch.int8, device=x.device) for _ in range(n_out)]
    pad = [0] * (3 - n_out)
    err = _build.kernels().adm_gn_act_quant(
        x.data_ptr(), int(x.dtype == torch.float32), *(v.data_ptr() for v in vecs), *pad, *pad, n_out,
        *(2 ** (b - 1) for (_s, _z, b) in quant_params), *pad, *(o.data_ptr() for o in outs), *pad,
        int(act == "swish"), B, HW, C, g, 1.0 / (HW * (C // g)), _build.stream_ptr(x.device))
    _build.check(err, "adm_gn_act_quant")
    gn_act_quant.launches += 1
    return tuple(outs)


gn_act_quant.launches = 0


# ---------------------------------------------------------------------------
# K7: resblock exit + the next GroupNorm's sums
# ---------------------------------------------------------------------------


def epilogue_residual_gn_stats_fits(HW: int, N: int, res_b: int = 4, out_b: int = 4) -> bool:
    """JAX's predicate for the fused exit (whole image in the TPU kernel's
    4 MiB block, N on the 128 grid, HW on the 8 grid)."""
    return HW * N * (4 + res_b + out_b + 4) <= WHOLE_IMAGE_BYTES and N % 128 == 0 and HW % 8 == 0


def gn_finalize_sums(sums, HW: int, cg: int):
    """[B, 2, G] sum / sum of squares -> (mean [B, G], rstd [B, G])."""
    return _finalize(sums[:, 0, :], sums[:, 1, :], 1.0 / (HW * cg))


def epilogue_residual_gn_stats_ref(dot, inv_ws, zcbias, x_res, *, out_dtype=torch.float32):
    """Plain version of K7, its sums in `window_sum`'s order."""
    B, N = dot.shape[0], dot.shape[-1]
    g = min(GROUPS, N)
    r = x_res.to(torch.float32).reshape(B, -1, N) + (dot.to(torch.float32).reshape(B, -1, N) * inv_ws + zcbias)
    s_g = _seq_sum(window_sum(r).reshape(B, g, N // g), -1)
    s2_g = _seq_sum(window_sum(r * r).reshape(B, g, N // g), -1)
    return r.to(out_dtype).reshape(dot.shape), torch.stack([s_g, s2_g], dim=1)


def epilogue_residual_gn_stats(dot, inv_ws, zcbias, x_res, *, out_dtype=torch.float32,
                               groups: int = GROUPS, plain: bool = False):
    """K7: dot [B, H, W, N] (conv2's int32 accumulator, or bf16 already
    dequantized with inv_ws = 1, zcbias = 0) and the shortcut branch x_res
    (f32 or bf16) -> (residual' = x_res + dot * inv_ws + zcbias at
    `out_dtype`, sums [B, 2, G] f32 of the f32 residual' per image and
    group, before the rounding to `out_dtype`).  `plain=True` runs the plain
    version on any device."""
    if groups != GROUPS:
        raise NotImplementedError(f"epilogue_residual_gn_stats: groups={groups}")
    if plain or dot.device.type == "cpu":
        return epilogue_residual_gn_stats_ref(dot, inv_ws, zcbias, x_res, out_dtype=out_dtype)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    g = min(GROUPS, N)
    if (dot.dtype not in (torch.bfloat16, torch.int32) or x_res.dtype not in (torch.float32, torch.bfloat16)
            or out_dtype not in (torch.float32, torch.bfloat16) or x_res.shape != dot.shape
            or N % g or N > 1024 or HW > WIN * WIN * CHUNK):
        raise NotImplementedError(
            f"epilogue_residual_gn_stats: dot {dot.dtype} {tuple(dot.shape)}, x_res {x_res.dtype} "
            f"{tuple(x_res.shape)}, out {out_dtype} (K7 takes bf16 or int32 dot, f32 or bf16 x_res and out of "
            f"one shape, N up to 1024, HW <= {WIN * WIN * CHUNK})")
    dot, x_res = dot.contiguous(), x_res.contiguous()
    iw, zc = _build.f32c(inv_ws, dot.device), _build.f32c(zcbias, dot.device)
    _build.require_cuda("epilogue_residual_gn_stats", dot, x_res, iw, zc)
    if iw.numel() != N or zc.numel() != N:
        raise ValueError(f"epilogue_residual_gn_stats: inv_ws and zcbias must hold {N} values")
    out = torch.empty(dot.shape, dtype=out_dtype, device=dot.device)
    sums = torch.empty((B, 2, g), dtype=torch.float32, device=dot.device)
    err = _build.kernels().adm_epilogue_residual_gn_stats(
        dot.data_ptr(), int(dot.dtype == torch.int32), iw.data_ptr(), zc.data_ptr(), x_res.data_ptr(),
        int(x_res.dtype == torch.float32), out.data_ptr(), int(out_dtype == torch.float32), sums.data_ptr(),
        B, HW, N, g, _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_residual_gn_stats")
    epilogue_residual_gn_stats.launches += 1
    return out, sums


epilogue_residual_gn_stats.launches = 0
