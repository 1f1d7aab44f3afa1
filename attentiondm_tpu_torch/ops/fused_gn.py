"""The fused GroupNorm kernels of the serving resblock (port of
`attentiondm_tpu/ops/fused_gn.py`): K4 `gn_act_quant` (the entry), K2 and
K6 `epilogue_gn_swish_quant` / `_blocked` (conv1 epilogue -> +temb ->
GroupNorm -> swish -> int8 quant) and K7 `epilogue_residual_gn_stats` (the
exit plus the next entry's statistics).

K4 (csrc/gn_act_quant.cu): GroupNorm -> swish or none -> one to three int8
quantizations of the same normalized tensor, on K2's kernels
(csrc/gn_epilogue.cuh) with x as the producer, launched as
`epilogue_plan(..., "K4")` says: the image form up to 32 windows, the
blocked form (K6's grid) past them on the 128-channel grid, the cluster form
elsewhere.  The serving step routes every entry that `gn_act_quant_takes`
admits to it.  K7
(csrc/epilogue_residual_gn_stats.cu): residual' = x_res + dequant(dot) and
the per-(image, group) sums [B, 2, G] of the f32 residual', which
`gn_finalize_sums` turns into the next GroupNorm's mean and rstd; on the
same kernels' image form with the exit as producer and the sums as
consumer, launched as `epilogue_plan(..., "K7")` says.

K2 and K6: one pass from conv1's output (bf16 already dequantized, or the int32
accumulator with `inv_ws` / `zcbias`) to conv2's int8 input; the float32
intermediate never reaches device memory.  `epilogue_gn_swish_quant`
routes by JAX's own predicate: images within the TPU kernel's whole-image
budget take K2 (`epilogue_gn_swish_quant_whole`, csrc/fused_gn.cu, a
cluster of blocks per image), larger ones on the 128-channel grid take K6
(`epilogue_gn_swish_quant_blocked`, csrc/fused_gn_blocked.cu, one launch
over chunks of 1024 rows), larger ones off that grid K2 again where its
plan takes them (JAX's XLA reference there), and the rest raise.  Both
launch as `epilogue_plan` says (csrc/gn_epilogue.cuh).

GroupNorm statistics follow the TPU kernel's `_gn_normalize`: per-group
sum and sum of squares in float32, variance E[x^2] - mu^2 clamped at 0
(not torch's two-pass `var`).  The float32 sums run in one fixed order,
`window_sum`'s, in the kernels and here alike, so kernel and plain version
give the same bits (csrc/common.cuh).  Every kernel and plain version
takes GroupNorm's `eps` (default `GN_EPS`, the DDPM UNet's 1e-6; ADM's
1e-5), handed to the kernels as a float32.  Swish is written
`h * (1 / (1 + exp(-h)))`, the kernel's formula.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..quant.primitives import div
from . import _build

GROUPS = 32  # the UNet's GroupNorm
GN_EPS = 1e-6  # the DDPM UNet's GroupNorm eps (ADM's is 1e-5): every kernel and plain version takes `eps`
WIN = 32  # rows per window of the float32 sums (csrc/common.cuh GN_WIN)
CHUNK = WIN * WIN  # rows per K6 block (GN_CHUNK)
WHOLE_IMAGE_BYTES = 4 * 1024 * 1024  # JAX's whole-image budget for K2: HW * N * (in bytes + 1)
RESIDUAL_DTYPES = (torch.bfloat16, torch.float32)  # the serving residual streams, which K4, K7 and K12 read


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


def _finalize(s_g, s2_g, inv_count: float, eps: float = GN_EPS):
    mean_g = s_g * inv_count
    var_g = torch.clamp(s2_g * inv_count - mean_g * mean_g, min=0.0)
    return mean_g, div(1.0, torch.sqrt(var_g + eps))


def _normalize(x, mean_g, rstd_g, gn_scale, gn_bias):
    cg = x.shape[-1] // mean_g.shape[-1]
    mean_c = mean_g.repeat_interleave(cg, dim=-1)[:, None, :]
    rstd_c = rstd_g.repeat_interleave(cg, dim=-1)[:, None, :]
    return (x - mean_c) * rstd_c * gn_scale + gn_bias


def gn_normalize(x, gn_scale, gn_bias, eps: float = GN_EPS):
    """x [B, HW, C] float32 -> GroupNorm(x) with E[x^2]-mu^2 statistics,
    summed per channel by `window_sum`, then per group in channel order."""
    B, HW, C = x.shape
    g = min(GROUPS, C)
    cg = C // g
    s_g = _seq_sum(window_sum(x).reshape(B, g, cg), -1)
    s2_g = _seq_sum(window_sum(x * x).reshape(B, g, cg), -1)
    mean_g, rstd_g = _finalize(s_g, s2_g, 1.0 / (HW * cg), eps)
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
                                act_zp, a_bit: int, eps: float = GN_EPS):
    """Plain version of K2."""
    h = gn_normalize(_epilogue_h(dot, inv_ws, zcbias, temb), gn_scale.float(), gn_bias.float(), eps)
    return quant_i8(swish(h), act_scale, act_zp, a_bit).reshape(dot.shape)


def epilogue_gn_swish_quant_blocked_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                        act_zp, a_bit: int, eps: float = GN_EPS):
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
    mean_g, rstd_g = _finalize(s_g, s2_g, 1.0 / (HW * cg), eps)
    h = _normalize(h, mean_g, rstd_g, gn_scale.float(), gn_bias.float())
    return quant_i8(swish(h), act_scale, act_zp, a_bit).reshape(dot.shape)


def epilogue_route(shape, dtype) -> str:
    """Which kernel takes a conv1 output of this shape: "K2" or "K6".  Within
    the whole-image budget K2, over it on K6's grid (N % 128 == 0, HW % 8 ==
    0) K6, as JAX's dispatcher (`attentiondm_tpu/ops/fused_gn.py`
    epilogue_gn_swish_quant).  Over the budget and off K6's grid JAX runs
    its XLA reference; here K2 takes the shape where its launch plan does (N
    a multiple of 8 up to 1024: the 4 MiB is the TPU's VMEM budget, not a
    Hopper limit).  The rest raise, naming the shape."""
    N = shape[-1]
    HW = 1
    for d in shape[1:-1]:
        HW *= d
    itemsize = torch.empty((), dtype=dtype).element_size()
    if HW * N * (itemsize + 1) <= WHOLE_IMAGE_BYTES:
        return "K2"
    if N % 128 == 0 and HW % 8 == 0:
        return "K6"
    try:
        epilogue_plan(shape[0], HW, N, dtype, "K2")
    except NotImplementedError as e:
        raise NotImplementedError(
            f"epilogue_gn_swish_quant: B={shape[0]}, HW={HW}, N={N} ({dtype}) is over the whole-image budget, off "
            f"the blocked kernel's grid (N % 128, HW % 8) and off K2's plans: {e}") from None
    return "K2"


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
MAX_N = 1024  # the widest channel count of K2, K6, K7 and the cluster form
IMAGE_MAX_N = 2048  # the image form's (K4 entries up to imagenet64's 2048-channel concats; GNE_IMAGE_MAX_N)
MAX_THREADS = 512  # the kernels' launch bound (up to 128 registers: 8 channels' constants)
K6_THREADS = 128  # four K6 blocks an SM: one's apply pass runs beside the others' first reads
IMAGE_ROWS = (1, 2, 4, 8, 16, 32)  # row groups of threads an image (or slice) the image form may take
K7_MAX_THREADS = 256  # K7's launch bound (csrc/gn_epilogue.cuh GNE_K7_THREADS; up to 255 registers: a batch of rows)
K7_BLOCK = 128  # the threads a K7 block aims at, where its row groups and slices allow (PERF.md)
K7_VECS = (8, 4, 2, 1)  # the channels a K7 thread may take
K4_BLOCKED_THREADS = (128, 512)  # the blocked form's blocks: WAVE_THREADS over the items, within these (PERF.md)


def max_threads(n_out: int) -> int:
    """The launch bound of the GroupNorm kernels with `n_out` int8 outputs
    (csrc/gn_epilogue.cuh GNE_BOUND): 2 or 3 outputs add 16 floats of
    constants a channel vector, so they are bounded at 256 threads (up to
    255 registers) instead of 512."""
    return MAX_THREADS if n_out == 1 else MAX_THREADS // 2


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
def epilogue_plan(B: int, HW: int, N: int, dtype, kind: str, n_out: int = 1, halo: bool = False) -> dict:
    """How K2 ("K2"), K6 ("K6") or K4's kernel ("K4", with `n_out` int8
    outputs, written halo'd where `halo`: K12's launches) spreads one call
    over the card.

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

    K4 (also K3's first launch, three outputs, and K12's two GroupNorm
    launches, on bf16 and on conv1's int32 accumulator): images of at most
    32 windows take the image form (`image_plans`: one block per image, or
    per slice of whole groups, no cluster), at least one row group a window
    where a plan has that many, and of those the one whose threads come
    nearest a wave (WAVE_THREADS; by ratio, ties to the more threads);
    larger images on the 128-channel grid with at most `SMS` chunks take the
    blocked form (`blocked_plans`: K6's persistent grid over (image, chunk)
    items, the block nearest a wave of threads over the B x chunks items,
    WAVE_THREADS / items held within K4_BLOCKED_THREADS, by ratio, ties to
    the fewer: few items want large blocks, many items small ones, whose
    apply passes run beside other blocks' first reads),
    unless the output is halo'd; the rest take the cluster form, ranked as
    K2's, bounded at `max_threads(n_out)`.  The image form takes N up to IMAGE_MAX_N: past
    1024 channels a row group of 8-channel threads outgrows the block, so
    the plan slices the image into more blocks of whole groups (a thread
    keeps its 8 channels and its registers), and the wave rule above picks
    between fewer row groups a block and more slices; the cluster form
    stops at MAX_N (JAX's one-pass budget admits no wider image past 32
    windows).  On the H100 the image form beat the cluster form
    at every K4 shape of up to 1024 rows, and this rule came within 8% of the
    best plan at each (`tools/gn_shapes.py --plans`, PERF.md).

    K7: the image form (`k7_plans`), the fewest row groups that give every
    window its own (more would idle: K7 has no apply pass to share among
    them; 32 at most, each then taking two or more windows); of the
    channels a thread those plans offer, the most whose threads in all make
    half a wave (a thread adds its window's rows in sequence, so where a
    step has few windows, fewer channels a thread shorten that; else the
    fewest); of those plans the one whose blocks come nearest K7_BLOCK
    threads (by ratio, ties to the more threads).  On the H100 this came
    within 7% of the best plan at every K7 shape of the CIFAR-10 and church
    steps (`tools/gn_shapes.py --plans`, PERF.md).

    Raises NotImplementedError for a shape the kernels do not take."""
    if kind == "K4":
        return _k4_plan(B, HW, N, dtype, n_out, halo)
    if kind == "K7":
        return _k7_plan(B, HW, N, dtype)
    if dtype not in (torch.bfloat16, torch.int32):
        raise NotImplementedError(f"epilogue_plan: {dtype} (K2 and K6 take bf16 or int32)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    g = min(GROUPS, N)
    V = N // VEC
    if N % VEC or N % g or N > MAX_N or HW < 1:
        raise NotImplementedError(f"epilogue_plan: N={N}, HW={HW} (N a multiple of {VEC} and of its groups, "
                                  f"up to {MAX_N})")
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

    return min(plans, key=lambda p: _cluster_rank(p, B, N, itemsize))


def _cluster_rank(p, B: int, N: int, itemsize: int):
    """A wave of threads, then the fewest blocks (else the most), then a held slab up to HOLD_MAX."""
    wave = B * p["cluster"] * p["threads"] >= WAVE_THREADS
    held = p["held"] and p["wpb"] * WIN * N * itemsize <= HOLD_MAX
    return (not wave, p["cluster"] if wave else -p["cluster"], not held, p["held"])


_ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4, torch.int32: 4}


def _k4_plan(B: int, HW: int, N: int, dtype, n_out: int, halo: bool) -> dict:
    if dtype not in _ITEMSIZE or not 1 <= n_out <= 3:
        raise NotImplementedError(f"epilogue_plan: K4 with {dtype} and {n_out} outputs (bf16, f32 or int32 in, "
                                  f"1 to 3 outputs)")
    g = min(GROUPS, N)
    if N % VEC or N % g or N > IMAGE_MAX_N or HW < 1 or HW > WIN * WIN * CHUNK:
        raise NotImplementedError(f"epilogue_plan: K4 at HW={HW}, N={N} (N a multiple of {VEC} and of its groups, "
                                  f"up to {IMAGE_MAX_N}; HW up to {WIN * WIN * CHUNK})")
    itemsize = _ITEMSIZE[dtype]
    image = image_plans(B, HW, N, n_out)
    if image:  # a row group for each window where the block allows it, then the nearest a wave
        V, nwin = N // VEC, -(-HW // WIN)
        image = [p for p in image if p["row_groups"] >= nwin] or image
        return min(image, key=lambda p: (abs(math.log2(B * V * p["row_groups"] / WAVE_THREADS)), -p["row_groups"]))
    blocked = [] if halo else blocked_plans(HW, N, n_out)
    if blocked:
        lo, hi = K4_BLOCKED_THREADS
        aim = min(hi, max(lo, WAVE_THREADS // (B * blocked[0]["blocks_per_image"])))
        return min(blocked, key=lambda p: (abs(math.log2(p["threads"] / aim)), p["threads"]))
    plans = k2_plans(HW, N, itemsize, max_threads(n_out), kind="K4")
    if not plans:
        raise NotImplementedError(f"epilogue_plan: K4 at HW={HW}, N={N} (what a block's shared memory holds; "
                                  f"past {WIN} windows N up to {MAX_N})")
    return min(plans, key=lambda p: _cluster_rank(p, B, N, itemsize))


def _image_smem(nwin: int, Ns: int) -> int:
    """csrc/gn_epilogue.cuh image_smem: the window sums [nwin, 2, Ns],
    channel sums [2, Ns] and mean / rstd [2, 32] of a block's slice."""
    return 4 * ((nwin + 1) * 2 * Ns + 2 * WIN)


def image_plans(B: int, HW: int, N: int, n_out: int = 1) -> list:
    """Every image-form plan of K4's kernel for B images of HW rows (at most
    32 windows) and N channels (up to IMAGE_MAX_N): per number of row groups
    R (IMAGE_ROWS, at most HW), the fewest channel slices of whole groups
    (`slices`, a power of two) whose R x (N / slices / 8) threads fit
    `max_threads(n_out)`, where its window sums fit the shared memory; a
    block a slice.  A block sums its windows (row group r taking windows r,
    r + R, ...), adds them in order, and applies its rows."""
    g = min(GROUPS, N)
    nwin = -(-HW // WIN)
    if N % VEC or N % g or N > IMAGE_MAX_N or HW < 1 or nwin > WIN:
        return []
    cg, mt = N // g, max_threads(n_out)
    plans = []
    for R in IMAGE_ROWS:
        if R > HW:
            break
        ns = 1
        while (N // ns) // VEC * R > mt and N % (2 * ns) == 0 and (N // (2 * ns)) % VEC == 0 \
                and (N // (2 * ns)) % cg == 0:
            ns *= 2
        T = (N // ns) // VEC * R
        if T > mt:
            continue
        smem = _image_smem(nwin, N // ns)
        if smem <= SMEM_MAX:
            plans.append(dict(kind="K4", form="image", slices=ns, row_groups=R, threads=T, smem=smem))
    return plans


def _blocked_smem(N: int, threads: int) -> int:
    """csrc/gn_epilogue.cuh entry_blocked_smem: the round buffer [R, 2, N]
    and chunk sums [2, N] of a chunk's sums, the image's channel sums [2, N]."""
    return 4 * 2 * N * (threads // (N // VEC) + 2)


def blocked_plans(HW: int, N: int, n_out: int = 1) -> list:
    """Every plan of K4's blocked form for images of HW rows (more than 32
    windows, at most `SMS` chunks of CHUNK rows) and N channels (a multiple
    of 128 up to MAX_N): per number of row groups R (IMAGE_ROWS), blocks of
    R x (N / 8) threads within `max_threads(n_out)`.  One
    cooperative launch of resident blocks takes (image, chunk) items in
    image-major order (`blocks_per_image` = chunks an image): an item sums
    its chunk, the image's last arrival adds the chunks' sums in
    `window_sum`'s order, and each item applies its chunk.  An image's
    chunks must all be in flight at once."""
    nwin, nchunk = -(-HW // WIN), -(-HW // CHUNK)
    if N % 128 or N > MAX_N or nwin <= WIN or nchunk > SMS or HW > WIN * WIN * CHUNK:
        return []
    V = N // VEC
    return [dict(kind="K4", form="blocked", blocks_per_image=nchunk, rows=CHUNK, threads=R * V,
                 smem=_blocked_smem(N, R * V))
            for R in IMAGE_ROWS if R * V <= max_threads(n_out)]


def k7_plans(HW: int, N: int) -> list:
    """Every plan K7's kernel takes for an image of HW rows (up to 32 * 32
    windows, the two levels of `window_sum` the kernel adds) and N channels:
    the image form, per number of channels a thread (`vec`, K7_VECS), of row
    groups R (IMAGE_ROWS, up to the first that gives every window its own)
    and of channel slices of whole groups and whole 8-channel vectors (a
    power of two) whose block of R x (N / slices / vec) threads fits
    K7_MAX_THREADS and holds a warp (or the whole image), with the shared
    memory of its window sums.  Row group r sums and writes windows r, r +
    R, ... of its slice, so no window has two owners."""
    g = min(GROUPS, N)
    nwin = -(-HW // WIN)
    if N % VEC or N % g or N > MAX_N or HW < 1 or nwin > WIN * WIN:
        return []
    cg = N // g
    plans = []
    for vec in K7_VECS:
        for R in IMAGE_ROWS:
            if R > HW:
                break
            ns = 1
            while True:
                T = (N // ns) // vec * R
                smem = _image_smem(nwin, N // ns)
                if T <= K7_MAX_THREADS and smem <= SMEM_MAX:
                    plans.append(dict(kind="K7", form="image", vec=vec, slices=ns, row_groups=R, threads=T,
                                      smem=smem))
                Ns = N // (2 * ns)
                if N % (2 * ns) or Ns % VEC or Ns % cg or T // 2 < 32:
                    break
                ns *= 2
            if R >= nwin:
                break
    return plans


def _k7_plan(B: int, HW: int, N: int, dtype) -> dict:
    if dtype not in (torch.bfloat16, torch.int32):
        raise NotImplementedError(f"epilogue_plan: K7 with {dtype} (bf16 or int32 conv2 output)")
    plans = k7_plans(HW, N)
    if not plans:
        raise NotImplementedError(f"epilogue_plan: K7 at HW={HW}, N={N} (N a multiple of {VEC} and of its groups, "
                                  f"up to {MAX_N}; HW up to {WIN * WIN * WIN})")
    nwin = -(-HW // WIN)
    R = min((p["row_groups"] for p in plans if p["row_groups"] >= nwin),
            default=max(p["row_groups"] for p in plans))
    vecs = sorted({p["vec"] for p in plans if p["row_groups"] == R}, reverse=True)
    vec = next((v for v in vecs if B * N // v * R >= WAVE_THREADS // 2), vecs[-1])
    return min((p for p in plans if p["row_groups"] == R and p["vec"] == vec),
               key=lambda p: (abs(math.log2(p["threads"] / K7_BLOCK)), -p["threads"]))


def k4_plans(B: int, HW: int, N: int, itemsize: int, n_out: int = 1, halo: bool = False) -> list:
    """Every plan K4's kernel takes for this shape: the image form's, the
    blocked form's (not with a halo'd output) and the cluster form's
    (`k2_plans` at `max_threads(n_out)`)."""
    blocked = [] if halo else blocked_plans(HW, N, n_out)
    return image_plans(B, HW, N, n_out) + blocked + k2_plans(HW, N, itemsize, max_threads(n_out), kind="K4")


@functools.lru_cache(maxsize=None)
def _plan_ints(vals: tuple):
    return _build.GNPLAN(*vals)


def plan_args(plan: dict):
    """The six ints a GroupNorm launcher reads (csrc/gn_epilogue.cuh GnPlan):
    form, blocks an image, channel slices or chunks an image, windows a block
    (0 in the image and blocked forms), threads, shared bytes, held."""
    if plan["form"] == "image":
        return _plan_ints((1, plan["slices"], 0, plan["threads"], plan["smem"], 0))
    if plan["form"] == "blocked":
        return _plan_ints((2, plan["blocks_per_image"], 0, plan["threads"], plan["smem"], 0))
    return _plan_ints((0, plan["cluster"], plan["wpb"], plan["threads"], plan["smem"], int(plan["held"])))


def k2_plans(HW: int, N: int, itemsize: int, max_thr: int = MAX_THREADS, kind: str = "K2") -> list:
    """Every cluster-form launch plan for an image of HW rows and N
    channels of `itemsize` bytes that the kernel takes: per cluster size, a
    block's windows and threads (at most `max_thr`), with the slab held in
    shared memory and without (where each fits)."""
    if HW > WIN * WIN * CHUNK or N % VEC or N > MAX_N:
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
            threads = min(WIN, max_thr // V) * V
        else:
            threads = max(V, min(max_thr, max(256, V * wpb)) // V * V)
        if threads > max_thr:
            continue
        for held in ((True, False) if wpb < WIN else (False,)):
            smem = _k2_smem(wpb, N, itemsize, threads, held)
            if smem <= SMEM_MAX:
                plans.append(dict(kind=kind, form="cluster", cluster=cl, wpb=wpb, rows=wpb * WIN, threads=threads,
                                  smem=smem, held=held))
    return plans


def _vectors(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp):
    vecs = [v.to(torch.float32).contiguous() for v in (inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp)]
    dot = dot.contiguous()
    return dot, vecs


def epilogue_gn_swish_quant(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                            a_bit: int, *, eps: float = GN_EPS, plain: bool = False):
    """dot [B, H, W, N] (bf16 or int32) -> int8 [B, H, W, N] input of the next
    conv; temb [B, N] is the time-embedding projection added before the
    statistics.  Routes to K2 or K6 (`epilogue_route`); `plain=True` runs
    the chosen kernel's plain version on any device."""
    if dot.dtype not in (torch.bfloat16, torch.int32):
        raise NotImplementedError(f"epilogue_gn_swish_quant: dot dtype {dot.dtype}")
    kernel = {"K2": epilogue_gn_swish_quant_whole, "K6": epilogue_gn_swish_quant_blocked}
    return kernel[epilogue_route(dot.shape, dot.dtype)](dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale,
                                                         act_zp, a_bit, eps=eps, plain=plain)


def epilogue_gn_swish_quant_whole(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                                  a_bit: int, *, eps: float = GN_EPS, plain: bool = False):
    """K2: `epilogue_gn_swish_quant`, a cluster of blocks per image
    (`epilogue_plan(..., "K2")`), at any shape the plan takes (N a multiple of
    8 up to 1024, HW up to 32 * 32 * CHUNK rows as shared memory allows).
    The serving path reaches it through the router; called directly it also
    runs at K6's shapes, for comparing the two.  `plain=True` runs the plain
    version on any device."""
    args = (dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp, a_bit)
    if plain or dot.device.type == "cpu":
        return epilogue_gn_swish_quant_ref(*args, eps)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    g = min(GROUPS, N)
    plan = epilogue_plan(B, HW, N, dot.dtype, "K2")
    dot, vecs = _vectors(*args[:-1])
    _build.require_cuda("epilogue_gn_swish_quant_whole", dot, *vecs)
    out = torch.empty(dot.shape, dtype=torch.int8, device=dot.device)
    err = _build.kernels().adm_epilogue_gn_swish_quant(
        dot.data_ptr(), int(dot.dtype == torch.int32), *(v.data_ptr() for v in vecs), out.data_ptr(),
        B, HW, N, g, 2 ** (a_bit - 1), 1.0 / (HW * (N // g)), eps,
        *(int(plan[k]) for k in ("cluster", "wpb", "threads", "smem", "held")), _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_gn_swish_quant")
    epilogue_gn_swish_quant_whole.launches += 1
    return out


epilogue_gn_swish_quant_whole.launches = 0


def epilogue_gn_swish_quant_blocked(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                                    a_bit: int, *, eps: float = GN_EPS, plain: bool = False):
    """K6: `epilogue_gn_swish_quant` for images over the whole-image budget
    (N a multiple of 128): one launch of resident blocks over (image, chunk
    of CHUNK rows) items (`epilogue_plan(..., "K6")`).  `plain=True` runs the
    plain version on any device."""
    if plain or dot.device.type == "cpu":
        return epilogue_gn_swish_quant_blocked_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias,
                                                   act_scale, act_zp, a_bit, eps)
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
        flags.data_ptr(), out.data_ptr(), B, HW, N, g, 2 ** (a_bit - 1), 1.0 / (HW * (N // g)), eps, plan["threads"],
        plan["smem"], _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_gn_swish_quant_blocked")
    epilogue_gn_swish_quant_blocked.launches += 1
    return out


epilogue_gn_swish_quant_blocked.launches = 0


# ---------------------------------------------------------------------------
# K4: GroupNorm -> swish or none -> n_out int8 quantizations
# ---------------------------------------------------------------------------


def gn_act_quant_ref(x, gn_scale, gn_bias, quant_params, *, act: str = "swish", eps: float = GN_EPS):
    """Plain version of K4."""
    B, C = x.shape[0], x.shape[-1]
    h = gn_normalize(x.to(torch.float32).reshape(B, -1, C), gn_scale.float(), gn_bias.float(), eps)
    if act == "swish":
        h = swish(h)
    return tuple(quant_i8(h, s, z, b).reshape(x.shape) for (s, z, b) in quant_params)


def gn_act_quant_takes(B: int, HW: int, C: int, dtype=torch.bfloat16, n_out: int = 1) -> bool:
    """Whether K4's CUDA kernel takes a [B, HW, C] input of `dtype` with
    `n_out` outputs: bf16 or f32, and a launch plan (`epilogue_plan(...,
    "K4")`: C a multiple of 8 and of its groups, up to 2048 in the image
    form, 1024 past 32 windows).  The serving step sends every GroupNorm
    entry it admits (without K7's sums) to K4."""
    if dtype not in RESIDUAL_DTYPES:
        return False
    try:
        epilogue_plan(B, HW, C, dtype, "K4", n_out)
    except NotImplementedError:
        return False
    return True


def gn_act_quant(x, gn_scale, gn_bias, quant_params, *, groups: int = GROUPS, act: str = "swish",
                 eps: float = GN_EPS, plain: bool = False):
    """K4: x [B, H, W, C] or [B, HW, C] (bf16 or f32) -> a tuple of int8
    tensors of x's shape, one per (act_scale [C], act_zp [C], a_bit) of
    `quant_params` (1 to 3), each the quantized GroupNorm(x) after `act`
    ("swish" or "none").  Launched as `epilogue_plan(..., "K4", n_out)`
    says.  `plain=True` runs the plain version on any device."""
    if act not in ("swish", "none"):
        raise ValueError(f"gn_act_quant: act={act!r}")
    if groups != GROUPS:
        raise NotImplementedError(f"gn_act_quant: groups={groups} (the UNet's GroupNorm has {GROUPS})")
    if plain or x.device.type == "cpu":
        return gn_act_quant_ref(x, gn_scale, gn_bias, quant_params, act=act, eps=eps)
    B, C = x.shape[0], x.shape[-1]
    HW = x.numel() // (B * C)
    g = min(GROUPS, C)
    n_out = len(quant_params)
    if x.dtype not in (torch.bfloat16, torch.float32) or not 1 <= n_out <= 3:
        raise NotImplementedError(f"gn_act_quant: {x.dtype}, {n_out} outputs (K4 takes bf16 or f32, 1 to 3 "
                                  f"outputs)")
    plan = epilogue_plan(B, HW, C, x.dtype, "K4", n_out)
    partial = flags = None
    if plan["form"] == "blocked":  # chunk sums [B, nchunk, 2, C] then mean / rstd [B, 2, g]; counters zeroed
        partial = torch.empty(B * (plan["blocks_per_image"] * 2 * C + 2 * g), dtype=torch.float32, device=x.device)
        flags = torch.zeros(1 + 2 * B, dtype=torch.int32, device=x.device)
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
        int(act == "swish"), B, HW, C, g, 1.0 / (HW * (C // g)), eps, *(None if t is None else t.data_ptr()
                                                                    for t in (partial, flags)),
        plan_args(plan), _build.stream_ptr(x.device))
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


def epilogue_residual_gn_stats_takes(HW: int, N: int) -> bool:
    """Whether K7's CUDA kernel takes an image of HW rows and N channels: a
    launch plan exists (`k7_plans`: N a multiple of 8 and of its groups, up
    to 1024; HW up to 32 * 32 windows, within a block's shared memory).  It
    covers every shape `epilogue_residual_gn_stats_fits` admits up to
    N = 1024."""
    return bool(k7_plans(HW, N))


def gn_finalize_sums(sums, HW: int, cg: int, eps: float = GN_EPS):
    """[B, 2, G] sum / sum of squares -> (mean [B, G], rstd [B, G]): K7's
    sums finalized at GroupNorm's `eps`."""
    return _finalize(sums[:, 0, :], sums[:, 1, :], 1.0 / (HW * cg), eps)


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
    group, before the rounding to `out_dtype`).  Launched as
    `epilogue_plan(..., "K7")` says; dot and x_res 16-byte aligned.
    `plain=True` runs the plain version on any device."""
    if groups != GROUPS:
        raise NotImplementedError(f"epilogue_residual_gn_stats: groups={groups}")
    if plain or dot.device.type == "cpu":
        return epilogue_residual_gn_stats_ref(dot, inv_ws, zcbias, x_res, out_dtype=out_dtype)
    B, N = dot.shape[0], dot.shape[-1]
    HW = dot.numel() // (B * N)
    g = min(GROUPS, N)
    if (dot.dtype not in (torch.bfloat16, torch.int32) or x_res.dtype not in (torch.float32, torch.bfloat16)
            or out_dtype not in (torch.float32, torch.bfloat16) or x_res.shape != dot.shape
            or not epilogue_residual_gn_stats_takes(HW, N)):
        raise NotImplementedError(
            f"epilogue_residual_gn_stats: dot {dot.dtype} {tuple(dot.shape)}, x_res {x_res.dtype} "
            f"{tuple(x_res.shape)}, out {out_dtype} (K7 takes bf16 or int32 dot, f32 or bf16 x_res and out of "
            f"one shape, N a multiple of 8 up to 1024, HW up to {WIN * WIN * WIN})")
    plan = epilogue_plan(B, HW, N, dot.dtype, "K7")
    dot, x_res = dot.contiguous(), x_res.contiguous()
    iw, zc = _build.f32c(inv_ws, dot.device), _build.f32c(zcbias, dot.device)
    _build.require_cuda("epilogue_residual_gn_stats", dot, x_res, iw, zc)
    if iw.numel() != N or zc.numel() != N:
        raise ValueError(f"epilogue_residual_gn_stats: inv_ws and zcbias must hold {N} values")
    if any(t.data_ptr() % 16 for t in (dot, x_res, iw, zc)):
        raise ValueError("epilogue_residual_gn_stats: dot, x_res, inv_ws and zcbias must be 16-byte aligned")
    out = torch.empty(dot.shape, dtype=out_dtype, device=dot.device)
    sums = torch.empty((B, 2, g), dtype=torch.float32, device=dot.device)
    err = _build.kernels().adm_epilogue_residual_gn_stats(
        dot.data_ptr(), int(dot.dtype == torch.int32), iw.data_ptr(), zc.data_ptr(), x_res.data_ptr(),
        int(x_res.dtype == torch.float32), out.data_ptr(), int(out_dtype == torch.float32), sums.data_ptr(),
        B, HW, N, g, plan_args(plan), plan["vec"], _build.stream_ptr(dot.device))
    _build.check(err, "adm_epilogue_residual_gn_stats")
    epilogue_residual_gn_stats.launches += 1
    return out, sums


epilogue_residual_gn_stats.launches = 0
