// K2: fused conv1 epilogue -> +temb -> GroupNorm(32, eps 1e-6) -> swish ->
// per-channel asymmetric int8 quant, the middle of every serving resblock
// whose image fits the TPU kernel's whole-image budget (larger ones take
// K6, fused_gn_blocked.cu).
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py
// epilogue_gn_swish_quant (_epi_gn_quant_kernel), which held whole images
// in VMEM.  One CIFAR level-0 image is 32*32*128*2 B = 256 KB of bf16, more
// than a Hopper block's 227 KB of shared memory, so this kernel keeps
// nothing but the statistics on chip:
//   one block per image;
//   pass 1 reads the image once, accumulating per-channel f32 sums and sums
//   of squares in the fixed windowed order of common.cuh, and mixes them
//   into groups (E[x^2] - mu^2 clamped at 0, as _gn_normalize);
//   pass 2 reads the image again (it mostly hits the 50 MB L2), normalizes,
//   applies swish and writes int8.
// The kernel itself (epi_gn_swish_quant_kernel) sits in common.cuh, on the
// GroupNorm -> swish -> quant pass it shares with K4, K3 and K12.
// What bounds it on the H100: device-memory bytes, about 2 B in and 1 B out
// per element plus the L2 re-read; 128 images give about one wave on 132
// SMs.  Vector loads and several images per SM are later work.
#include "common.cuh"

using namespace adm;

extern "C" int adm_epilogue_gn_swish_quant(const void* x, int x_is_int32, const void* inv_ws,
                                           const void* zcbias, const void* temb, const void* gn_scale,
                                           const void* gn_bias, const void* act_scale,
                                           const void* act_zp, void* out, int B, int HW, int N,
                                           int groups, int n_levels, float inv_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GnQuantArgs a = {};
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  a.scale[0] = static_cast<const float*>(act_scale);
  a.zp[0] = static_cast<const float*>(act_zp);
  a.out[0] = static_cast<int8_t*>(out);
  a.n_levels[0] = n_levels;
  a.n_out = 1; a.swish = 1; a.HW = HW; a.N = N; a.G = groups; a.inv_count = inv_count; a.halo_w = 0;
  const float *iw = static_cast<const float*>(inv_ws), *zc = static_cast<const float*>(zcbias),
              *te = static_cast<const float*>(temb);
  if (x_is_int32) return (int)launch_epi_gn_swish_quant(static_cast<const int32_t*>(x), iw, zc, te, a, B, s);
  return (int)launch_epi_gn_swish_quant(static_cast<const __nv_bfloat16*>(x), iw, zc, te, a, B, s);
}
