// K12: a whole identity-residual serving resblock (`resblock_pallas`):
//   r -> GN1 -> swish -> quant -> conv1 (3x3 int8, quantized-zero halo) ->
//   dequant -> +temb -> GN2 -> swish -> quant -> conv2 -> dequant -> + r,
// the residual read at its dtype (bf16) and the result written once.
//
// Replaces the TPU kernel attentiondm_tpu/ops/pallas_resblock.py
// resblock_pallas (_kernel), one program per batch block with the residual,
// both halo'd int8 conv inputs and the int32 accumulator in VMEM (a 10 MiB
// plan).  One 32*32*128 image is 256 KB in bf16 alone, over a Hopper
// block's 227 KB of shared memory, and a 3x3 conv needs its neighbours'
// rows, so the block cannot be carried over program for program.  Like K3
// it is one C entry point and one launch count with a chain of launches
// behind it, made of the device code the other kernels use, in the TPU
// kernel's order of operations:
//   1. the K4 pass (common.cuh gn_act_quant_image): GN1 -> swish -> int8,
//      written straight into the halo'd conv1 input, border filled with
//      clip(round(-zp)) per channel;
//   2. conv1: the int8 implicit GEMM (igemm.cuh), int32 accumulator out;
//   3. the K2 pass on that accumulator: acc * inv_ws + zcbias + temb in f32
//      (no bf16 rounding between conv1 and GN2, as the TPU kernel), GN2 ->
//      swish -> int8, again into a halo'd buffer;
//   4. conv2: the implicit GEMM with the dequant + residual-add epilogue,
//      r + (acc * inv_ws + zcbias) rounded once to bf16.
// Against the unfused resblock this drops the plain-torch halo padding, the
// entry's separate passes and the exit's dequant and add.  What still goes
// through device memory between the launches: the two halo'd int8 conv
// inputs (1 B per element each, read 9 times by the GEMM, mostly from L2)
// and the int32 accumulator of conv1 (4 B written, read twice by pass 3).
// What bounds it on the H100: the two GEMMs' tensor-core arithmetic
// (2 * 2 * 9 * C * C operations per pixel; igemm.cuh's wgmma core), then the
// bytes above.  Fusing pass 3 into conv1's epilogue needs the GroupNorm
// statistics across GEMM tiles (a K6-style partial-sum buffer); later work.
#include "igemm.cuh"

using namespace adm;

static GnQuantArgs halo_args(const void* gn_scale, const void* gn_bias, const void* scale, const void* zp,
                             int n_levels, void* pad, int H, int W, int C, int G, float inv_count) {
  GnQuantArgs a = {};
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  a.scale[0] = static_cast<const float*>(scale);
  a.zp[0] = static_cast<const float*>(zp);
  a.out[0] = static_cast<int8_t*>(pad);
  a.n_levels[0] = n_levels;
  a.n_out = 1; a.swish = 1; a.HW = H * W; a.N = C; a.G = G; a.inv_count = inv_count; a.halo_w = W;
  return a;
}

static IgemmArgs conv_args(const void* pad, const void* gt, const void* inv_ws, const void* zcbias, void* out,
                           int B, int H, int W, int C, const int* tile) {
  IgemmArgs a;
  a.x = static_cast<const int8_t*>(pad);
  a.wt = static_cast<const int8_t*>(gt);
  a.inv_ws = static_cast<const float*>(inv_ws);
  a.zcbias = static_cast<const float*>(zcbias);
  a.res = nullptr;
  a.out = out;
  a.B = B; a.Hp = H + 2; a.Wp = W + 2; a.Cp = C; a.Ho = H; a.Wo = W; a.Np = C; a.stride = 1;
  a.tile = IgemmTile{tile[0], tile[1], tile[2], tile[3]};
  return a;
}

// r [B, H, W, C] bf16; tproj [B, C] f32; v1, v2: the six [C] f32 vectors of
// each half in the order GroupNorm scale, bias, activation quant scale,
// zero point, conv inv_ws, zcbias; g1t, g2t [C, 9C] int8, the folds K-major;
// scratch pad1, pad2 [B, H+2, W+2, C] int8 and acc [B, H, W, C] int32; out
// [B, H, W, C] bf16; tile: the GEMMs' M tiling (bm, cols, rows, imgs)
extern "C" int adm_resblock(const void* r, const void* tproj, const void* const* v1, int n1, const void* g1t,
                            const void* const* v2, int n2, const void* g2t, void* pad1, void* acc, void* pad2,
                            void* out, int B, int H, int W, int C, int groups, float inv_count, const int* tile,
                            void* stream) {
  if (C % 128 != 0 || C > 1024 || groups > 32 || C % groups != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err = launch_gn_act_quant(static_cast<const __nv_bfloat16*>(r),
                                        halo_args(v1[0], v1[1], v1[2], v1[3], n1, pad1, H, W, C, groups, inv_count),
                                        B, s);
  if (err != cudaSuccess) return (int)err;

  err = launch_igemm<3, EPI_I32>(conv_args(pad1, g1t, v1[4], v1[5], acc, B, H, W, C, tile), s);
  if (err != cudaSuccess) return (int)err;

  err = launch_epi_gn_swish_quant(static_cast<const int32_t*>(acc), static_cast<const float*>(v1[4]),
                                  static_cast<const float*>(v1[5]), static_cast<const float*>(tproj),
                                  halo_args(v2[0], v2[1], v2[2], v2[3], n2, pad2, H, W, C, groups, inv_count),
                                  B, s);
  if (err != cudaSuccess) return (int)err;

  IgemmArgs a = conv_args(pad2, g2t, v2[4], v2[5], out, B, H, W, C, tile);
  a.res = static_cast<const __nv_bfloat16*>(r);
  return (int)launch_igemm<3, EPI_RESADD_BF16>(a, s);
}
