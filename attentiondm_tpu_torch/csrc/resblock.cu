// K12: a whole identity-residual serving resblock (`resblock_pallas`):
//   r -> GN1 -> swish -> quant -> conv1 (3x3 int8, quantized-zero halo) ->
//   dequant -> +temb -> GN2 -> swish -> quant -> conv2 -> dequant -> + r,
// the residual read at its dtype (bf16, or f32: the float32 residual stream)
// and the result written once at that dtype.
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
//   1. GN1 -> swish -> int8 on gn_epilogue.cuh (K4's kernel: x as it is),
//      written straight into the halo'd conv1 input by the halo'd consumer,
//      whose blocks also fill the border with clip(round(-zp)) per channel;
//   2. conv1: the int8 implicit GEMM (igemm.cuh), int32 accumulator out;
//   3. the same GroupNorm kernel with K2's producer on that accumulator:
//      acc * inv_ws + zcbias + temb in f32 (no bf16 rounding between conv1
//      and GN2, as the TPU kernel), GN2 -> swish -> int8, again halo'd;
//   4. conv2: the implicit GEMM with the dequant + residual-add epilogue,
//      r + (acc * inv_ws + zcbias) rounded once to bf16, or kept in f32.
// Launch 1 reads r as it is (bf16 or f32: K4's two input types), launch 4
// adds it in EPI_RESADD_BF16 or EPI_RESADD_F32.
// Launches 1 and 3 take the plans ops/fused_gn.epilogue_plan(..., "K4", halo=True)
// gives their shape and input type (the image form at every serving shape).  Against the unfused resblock this drops the
// plain-torch halo padding, the entry's separate passes and the exit's
// dequant and add.  What still goes through device memory between the
// launches: the two halo'd int8 conv inputs (1 B per element each, read 9
// times by the GEMM, mostly from L2) and the int32 accumulator of conv1 (4 B
// written, read once by pass 3, twice where its plan re-reads from L2).
// What bounds it on the H100: the two GEMMs' tensor-core arithmetic
// (2 * 2 * 9 * C * C operations per pixel; igemm.cuh's wgmma core), then the
// bytes above.  Fusing pass 3 into conv1's epilogue needs the GroupNorm
// statistics across GEMM tiles aligned to the 32-row windows; later work.
#include "gn_epilogue.cuh"
#include "igemm.cuh"

using namespace adm;

// GroupNorm -> swish -> int8 of one half, written halo'd into `pad`: the
// producer's epilogue vectors are set by the caller where it has one
static EpiArgs halo_args(const void* x, const void* gn_scale, const void* gn_bias, const void* scale,
                         const void* zp, int n_levels, void* pad, int B, int H, int W, int C, int G,
                         float inv_count, float eps) {
  EpiArgs a = {};
  a.x = x;
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  a.act_scale[0] = static_cast<const float*>(scale);
  a.act_zp[0] = static_cast<const float*>(zp);
  a.out[0] = static_cast<int8_t*>(pad);
  a.n_levels[0] = n_levels;
  a.B = B; a.HW = H * W; a.N = C; a.G = G; a.swish = 1; a.halo_w = W; a.inv_count = inv_count; a.eps = eps;
  return a;
}

static GnPlan plan_of(const int* p) { return GnPlan{p[0], p[1], p[2], p[3], p[4], p[5]}; }

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

// r [B, H, W, C] bf16 or f32 (r_is_f32); tproj [B, C] f32; v1, v2: the six [C] f32 vectors of
// each half in the order GroupNorm scale, bias, activation quant scale,
// zero point, conv inv_ws, zcbias; g1t, g2t [C, 9C] int8, the folds K-major;
// scratch pad1, pad2 [B, H+2, W+2, C] int8 and acc [B, H, W, C] int32; out
// [B, H, W, C] at r's dtype; tile: the GEMMs' M tiling (bm, cols, rows, imgs); plan1,
// plan3: the GroupNorm launches' plans (ops/fused_gn.plan_args)
extern "C" int adm_resblock(const void* r, int r_is_f32, const void* tproj, const void* const* v1, int n1, const void* g1t,
                            const void* const* v2, int n2, const void* g2t, void* pad1, void* acc, void* pad2,
                            void* out, int B, int H, int W, int C, int groups, float inv_count, float eps, const int* tile,
                            const int* plan1, const int* plan3, void* stream) {
  if (C % 128 != 0 || C > 1024 || groups > 32 || C % groups != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err = launch_gn_x<1, true>(
      halo_args(r, v1[0], v1[1], v1[2], v1[3], n1, pad1, B, H, W, C, groups, inv_count, eps), r_is_f32, plan_of(plan1), s);
  if (err != cudaSuccess) return (int)err;

  err = launch_igemm<3, EPI_I32>(conv_args(pad1, g1t, v1[4], v1[5], acc, B, H, W, C, tile), s);
  if (err != cudaSuccess) return (int)err;

  EpiArgs a3 = halo_args(acc, v2[0], v2[1], v2[2], v2[3], n2, pad2, B, H, W, C, groups, inv_count, eps);
  a3.inv_ws = static_cast<const float*>(v1[4]);
  a3.zcbias = static_cast<const float*>(v1[5]);
  a3.temb = static_cast<const float*>(tproj);
  err = launch_gn<int32_t, true, 1, true>(a3, plan_of(plan3), s);
  if (err != cudaSuccess) return (int)err;

  IgemmArgs a = conv_args(pad2, g2t, v2[4], v2[5], out, B, H, W, C, tile);
  a.res = r;
  return (int)(r_is_f32 ? launch_igemm<3, EPI_RESADD_F32>(a, s) : launch_igemm<3, EPI_RESADD_BF16>(a, s));
}
