"""K1: the int8 implicit-GEMM convolution, the port's conv core.

Replaces `attentiondm_tpu/ops/pallas_conv.int8_conv3_pallas` (implicit-im2col
3x3 int8 conv, int32 accumulation, then `acc*inv_ws + zcbias` to bf16 or the
raw int32).  On the TPU XLA's own int8 convolution ran most of these convs;
PyTorch has no CUDA int8 convolution at all, so here every int8 conv of the
serving step goes through this kernel (csrc/int8_conv.cu):

  ksize 3, stride 1, bf16 out   resblock conv1/conv2 (dot_bf16 layout)
  ksize 3, stride 1, int32 out  upsample conv, conv_out (also the math of
                                the TPU's `_conv3x3_int8_dot`, K13)
  ksize 3, stride 2, int32 out  downsample conv (asymmetric (0,1) halo)
  ksize 1, stride 1, int32 out  nin_shortcut (the math of `int8_matmul`, K5)
  res= (bf16 or f32)            res + (acc*inv_ws + zcbias) at the residual's
                                dtype: the last launch of K12 (3x3) and K3
                                (1x1), run alone here for their checks

Interface: the caller supplies the int8 NHWC input with its halo already
applied ([B, H+2, W+2, Cp] for 3x3 stride 1, [B, H+1, W+1, Cp] for the
stride-2 downsample, [B, H, W, Cp] for 1x1) and the fold-layout weights
gq [ks*ks*Cp, Np] (rows in (dy, dx, c) order).  Cp and Np are multiples of
128.  `int8_conv` launches the kernel for a CUDA tensor and takes the plain
version `int8_conv_ref` only for a CPU tensor.

The kernel's products are `wgmma`, which reads 8-bit operands only with K
contiguous, so it takes the weights K-major: `gqt` [Np, ks*ks*Cp], the
transpose of the fold layout.  `prepare_serving_runtime` stores that copy per
layer at fold time and the serving path hands it on; a call without it
transposes `gq` on the fly.  The M tiling of a launch (`conv_tiles`) is
chosen here, in Python, and passed to the kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .quant_conv import int8_matmul_ref

_MODES = {torch.int32: 0, torch.bfloat16: 1}  # csrc/igemm.cuh Epilogue
_RESADD_MODES = {torch.bfloat16: 3, torch.float32: 4}  # EPI_RESADD_BF16, EPI_RESADD_F32
VMEM_BUDGET = 8 << 20  # the TPU conv kernel's plan, kept for JAX's routing predicates


def conv3_pallas_fits(B: int, H: int, W: int, Cp: int, Np: int) -> bool:
    """JAX's eligibility of a 3x3 shape for its conv kernel: channels on the
    128 grid and the TPU kernel's plan (weights, one halo'd image, its
    accumulator and output) within its budget."""
    return Cp % 128 == 0 and Np % 128 == 0 and 9 * Cp * Np + (H + 2) * (W + 2) * Cp + H * W * Np * 6 <= VMEM_BUDGET


def conv3_pallas_wins(B: int, H: int, W: int, Cp: int, Np: int) -> bool:
    """JAX's per-shape routing policy for its conv kernel, a pure predicate:
    every shape but (Cp, Np) = (128, 128), and below 8x8 only Cp >= 512 with
    Np >= 256.  `resblock_pallas=True` gates K12 on it, as JAX does."""
    if H < 8 or W < 8:
        return Cp >= 512 and Np >= 256
    return not (Cp == 128 and Np == 128)


def qzero(zp, a_bit: int):
    """Each channel's quantized zero, clip(round(-zp), -n, n - 1): the int8
    code that decodes to 0.0."""
    n = 2 ** (a_bit - 1)
    return torch.clamp(torch.round(-zp), -n, n - 1).to(torch.int8)


def pad_qzero(xq, zp, a_bit: int):
    """Spatial +1 halo filled with each channel's quantized zero."""
    B, H, W, C = xq.shape
    out = qzero(zp, a_bit).expand(B, H + 2, W + 2, C).clone()
    out[:, 1:H + 1, 1:W + 1, :] = xq
    return out


def _out_hw(Hp: int, Wp: int, ksize: int, stride: int):
    return (Hp - ksize) // stride + 1, (Wp - ksize) // stride + 1


SMS = 132  # streaming multiprocessors of the H100: tiles are sized so that a launch has work for each


class ConvTiles(NamedTuple):
    """The M tiling of one GEMM launch: tiles of `BM` accumulator rows by `BN`
    output channels; a tile's rows are the `cols` x `rows` x `imgs` box of
    output pixels at (ox0, oy0, b0), row r being pixel (r // (cols * rows),
    r // cols % rows, r % cols) of the box; `grid` = (tiles along x, y, batch,
    output channels)."""

    BM: int
    BN: int
    cols: int
    rows: int
    imgs: int
    grid: tuple


@functools.lru_cache(maxsize=None)
def conv_tiles(B: int, Ho: int, Wo: int, ksize: int, stride: int, Np: int) -> ConvTiles:
    """How K1's kernel cuts the [B, Ho, Wo] output pixels of a launch into M
    tiles, a pure function of the shape.  A tile is one TMA box per tap: part
    of an output row where Wo exceeds BM, whole rows of one image, or whole
    images where an image has fewer pixels than BM (the 8x8 and 4x4 maps); a
    box is clipped to the tensor, so ragged edges cost accumulator rows, never
    a second path.  A 1x1 conv is the flat GEMM over its B * Ho * Wo rows.
    BM is 128, or 64 where 128-row tiles would leave SMs without a tile."""
    del stride  # the tiling is over output pixels, whatever the stride
    if ksize == 1:
        B, Ho, Wo = 1, 1, B * Ho * Wo

    def cut(bm):
        cols = min(Wo, bm)
        rows = min(Ho, bm // cols)
        imgs = min(B, bm // (cols * rows))
        return cols, rows, imgs, (-(-Wo // cols), -(-Ho // rows), -(-B // imgs), Np // 128)

    for bm in (128, 64):
        cols, rows, imgs, grid = cut(bm)
        if bm == 64 or grid[0] * grid[1] * grid[2] * grid[3] >= SMS:
            return ConvTiles(bm, 128, cols, rows, imgs, grid)


def conv_tile_rows(t: ConvTiles, B: int, Ho: int, Wo: int, ksize: int = 3):
    """The output row m = (b * Ho + oy) * Wo + ox of every accumulator row of
    every M tile, in the kernel's order, or -1 where the row is masked: an
    int64 tensor [tiles, BM].  What the kernel's epilogue computes, for the
    tests."""
    if ksize == 1:
        B, Ho, Wo = 1, 1, B * Ho * Wo
    tx, ty, tb, _ = t.grid
    mt = torch.arange(tx * ty * tb)[:, None]
    ox0, oy0, b0 = mt % tx * t.cols, mt // tx % ty * t.rows, mt // (tx * ty) * t.imgs
    r = torch.arange(t.BM)[None, :]
    ib, iy, ix = r // (t.cols * t.rows), r // t.cols % t.rows, r % t.cols
    valid = (ib < t.imgs) & (b0 + ib < B) & (oy0 + iy < Ho) & (ox0 + ix < Wo)
    m = ((b0 + ib) * Ho + oy0 + iy) * Wo + ox0 + ix
    return torch.where(valid, m, torch.full_like(m, -1))


def k_major(gq):
    """The K-major copy [..., Np, K] of fold-layout weights [..., K, Np]."""
    return gq.transpose(-1, -2).contiguous()


def int8_conv_ref(xp, gq, inv_ws=None, zcbias=None, *, ksize: int = 3, stride: int = 1,
                  out_dtype=torch.int32, res=None):
    """Plain version of `int8_conv`: one exact integer product per tap."""
    B, Hp, Wp, Cp = xp.shape
    Ho, Wo = _out_hw(Hp, Wp, ksize, stride)
    Np = gq.shape[-1]
    acc = torch.zeros((B * Ho * Wo, Np), dtype=torch.int32, device=xp.device)
    for dy in range(ksize):
        for dx in range(ksize):
            tap = xp[:, dy:dy + stride * (Ho - 1) + 1:stride, dx:dx + stride * (Wo - 1) + 1:stride, :]
            k0 = (dy * ksize + dx) * Cp
            acc += int8_matmul_ref(tap.reshape(-1, Cp), gq[k0:k0 + Cp])
    acc = acc.reshape(B, Ho, Wo, Np)
    if res is not None:
        return (res.to(torch.float32) + (acc.to(torch.float32) * inv_ws + zcbias)).to(res.dtype)
    if out_dtype == torch.int32:
        return acc
    return (acc.to(torch.float32) * inv_ws + zcbias).to(torch.bfloat16)


def int8_conv(xp, gq, inv_ws=None, zcbias=None, *, ksize: int = 3, stride: int = 1,
              out_dtype=torch.int32, gqt=None, res=None, plain: bool = False):
    """int8 NHWC conv over a halo-padded input -> int32 [B, Ho, Wo, Np], or
    bf16 of `acc * inv_ws + zcbias` (f32 math, one rounding to bf16), or with
    `res` [B, Ho, Wo, Np] (bf16 or f32) `res + (acc * inv_ws + zcbias)` at
    res's dtype (`out_dtype` must be it): rounded once to bf16, or not at all
    in f32.

    The weights come in the fold layout `gq` [ks*ks*Cp, Np], K-major as `gqt`
    [Np, ks*ks*Cp] (`gq` may then be None), or both (the serving path: the
    kernel reads `gqt`, the plain version `gq`).  `plain=True` runs the plain
    version on any device (for comparisons)."""
    if ksize not in (1, 3) or stride not in (1, 2) or (ksize == 1 and stride != 1):
        raise NotImplementedError(f"int8_conv: ksize={ksize} stride={stride}")
    modes = _MODES if res is None else _RESADD_MODES
    if out_dtype not in modes or (res is not None and res.dtype != out_dtype):
        raise NotImplementedError(f"int8_conv: out_dtype={out_dtype}, res {None if res is None else res.dtype} "
                                  f"(int32 or bf16 out; with res, bf16 or f32 in and out)")
    B, Hp, Wp, Cp = xp.shape
    K = ksize * ksize * Cp
    if gq is None and gqt is None:
        raise ValueError("int8_conv: needs the weights, gq [K, Np] or gqt [Np, K]")
    Np = gq.shape[-1] if gq is not None else gqt.shape[0]
    for w, shape in ((gq, (K, Np)), (gqt, (Np, K))):
        if w is not None and (w.dtype != torch.int8 or tuple(w.shape) != shape):
            raise ValueError(f"int8_conv: xp {xp.dtype} {tuple(xp.shape)}, weights {w.dtype} {tuple(w.shape)}, "
                             f"expected int8 {shape}")
    if xp.dtype != torch.int8:
        raise ValueError(f"int8_conv: xp {xp.dtype} {tuple(xp.shape)}")
    if out_dtype != torch.int32 and (inv_ws is None or zcbias is None):
        raise ValueError(f"int8_conv: out_dtype={out_dtype} needs inv_ws and zcbias")
    if Cp % 128 or Np % 128:
        raise ValueError(f"int8_conv: Cp={Cp} and Np={Np} must be multiples of 128")
    Ho, Wo = _out_hw(Hp, Wp, ksize, stride)
    if res is not None and tuple(res.shape) != (B, Ho, Wo, Np):
        raise ValueError(f"int8_conv: res {tuple(res.shape)} != the output's {(B, Ho, Wo, Np)}")
    if plain or xp.device.type == "cpu":
        return int8_conv_ref(xp, gq if gq is not None else gqt.t(), inv_ws, zcbias, ksize=ksize, stride=stride,
                             out_dtype=out_dtype, res=res)

    if inv_ws is None:  # int32 mode reads no epilogue vectors
        inv_ws = zcbias = torch.empty(0, dtype=torch.float32, device=xp.device)
    inv_ws, zcbias = _build.f32c(inv_ws), _build.f32c(zcbias)
    gqt = k_major(gq) if gqt is None else gqt
    _build.require_cuda("int8_conv", xp, gqt, inv_ws, zcbias, *(() if res is None else (res,)))
    out = torch.empty((B, Ho, Wo, Np), dtype=out_dtype, device=xp.device)
    t = conv_tiles(B, Ho, Wo, ksize, stride, Np)
    err = _build.kernels().adm_int8_conv(
        xp.data_ptr(), gqt.data_ptr(), inv_ws.data_ptr(), zcbias.data_ptr(), None if res is None else res.data_ptr(),
        out.data_ptr(), B, Hp, Wp, Cp, Ho, Wo, Np, ksize, stride, modes[out_dtype], t.BM, t.cols, t.rows, t.imgs,
        _build.stream_ptr(xp.device))
    _build.check(err, "adm_int8_conv")
    int8_conv.launches += 1
    key = f"{ksize}x{ksize}/s{stride}/{'' if res is None else 'resadd_'}{str(out_dtype).removeprefix('torch.')}"
    int8_conv.launches_by_mode[key] = int8_conv.launches_by_mode.get(key, 0) + 1
    return out


int8_conv.launches = 0
int8_conv.launches_by_mode = {}
