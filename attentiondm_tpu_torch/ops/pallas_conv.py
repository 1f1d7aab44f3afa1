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

Interface: the caller supplies the int8 NHWC input with its halo already
applied ([B, H+2, W+2, Cp] for 3x3 stride 1, [B, H+1, W+1, Cp] for the
stride-2 downsample, [B, H, W, Cp] for 1x1) and the fold-layout weights
gq [ks*ks*Cp, Np] (rows in (dy, dx, c) order).  Cp and Np are multiples of
128.  `int8_conv` launches the kernel for a CUDA tensor and takes the plain
version `int8_conv_ref` only for a CPU tensor.
"""
from __future__ import annotations

import torch

from . import _build
from .quant_conv import int8_matmul_ref

_MODES = {torch.int32: 0, torch.bfloat16: 1}


def _out_hw(Hp: int, Wp: int, ksize: int, stride: int):
    return (Hp - ksize) // stride + 1, (Wp - ksize) // stride + 1


def int8_conv_ref(xp, gq, inv_ws=None, zcbias=None, *, ksize: int = 3, stride: int = 1,
                  out_dtype=torch.int32):
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
    if out_dtype == torch.int32:
        return acc
    return (acc.to(torch.float32) * inv_ws + zcbias).to(torch.bfloat16)


def int8_conv(xp, gq, inv_ws=None, zcbias=None, *, ksize: int = 3, stride: int = 1,
              out_dtype=torch.int32, plain: bool = False):
    """int8 NHWC conv over a halo-padded input -> int32 [B, Ho, Wo, Np], or
    bf16 of `acc * inv_ws + zcbias` (f32 math, one rounding to bf16).

    `plain=True` runs the plain version on any device (for comparisons)."""
    if ksize not in (1, 3) or stride not in (1, 2) or (ksize == 1 and stride != 1):
        raise NotImplementedError(f"int8_conv: ksize={ksize} stride={stride}")
    if out_dtype not in _MODES:
        raise NotImplementedError(f"int8_conv: out_dtype={out_dtype}")
    B, Hp, Wp, Cp = xp.shape
    Np = gq.shape[-1]
    if xp.dtype != torch.int8 or gq.dtype != torch.int8 or gq.shape[0] != ksize * ksize * Cp:
        raise ValueError(f"int8_conv: xp {xp.dtype} {tuple(xp.shape)}, gq {gq.dtype} {tuple(gq.shape)}")
    if Cp % 128 or Np % 128:
        raise ValueError(f"int8_conv: Cp={Cp} and Np={Np} must be multiples of 128")
    if plain or xp.device.type == "cpu":
        return int8_conv_ref(xp, gq, inv_ws, zcbias, ksize=ksize, stride=stride, out_dtype=out_dtype)

    Ho, Wo = _out_hw(Hp, Wp, ksize, stride)
    if inv_ws is None:  # int32 mode reads no epilogue vectors
        inv_ws = zcbias = torch.empty(0, dtype=torch.float32, device=xp.device)
    inv_ws = inv_ws.to(torch.float32).contiguous()
    zcbias = zcbias.to(torch.float32).contiguous()
    _build.require_cuda("int8_conv", xp, gq, inv_ws, zcbias)
    out = torch.empty((B, Ho, Wo, Np), dtype=out_dtype, device=xp.device)
    err = _build.kernels().adm_int8_conv(
        xp.data_ptr(), gq.data_ptr(), inv_ws.data_ptr(), zcbias.data_ptr(), out.data_ptr(),
        B, Hp, Wp, Cp, Ho, Wo, Np, ksize, stride, _MODES[out_dtype], _build.stream_ptr(xp.device))
    _build.check(err, "adm_int8_conv")
    int8_conv.launches += 1
    key = f"{ksize}x{ksize}/s{stride}/{str(out_dtype).removeprefix('torch.')}"
    int8_conv.launches_by_mode[key] = int8_conv.launches_by_mode.get(key, 0) + 1
    return out


int8_conv.launches = 0
int8_conv.launches_by_mode = {}
