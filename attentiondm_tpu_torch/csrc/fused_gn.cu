// K2: fused conv1 epilogue -> +temb -> GroupNorm(32, eps 1e-6) -> swish ->
// per-channel asymmetric int8 quant, the middle of every serving resblock
// whose image fits the TPU kernel's whole-image budget (larger ones take
// K6, fused_gn_blocked.cu).
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py
// epilogue_gn_swish_quant (_epi_gn_quant_kernel), which held whole images
// in VMEM.  A Hopper block holds 227 KB, and one block per image fills only
// B of the 132 SMs, so the image is spread over a thread-block cluster
// (epi_gn_cluster_kernel in gn_epilogue.cuh, launched as
// ops/fused_gn.epilogue_plan says):
//   each block owns whole 32-row windows and sums them per channel, 8
//   channels a thread with 16-byte loads, in the fixed windowed order of
//   common.cuh;
//   each block adds up a share of the channels' window (or chunk) sums from
//   every block of the cluster through distributed shared memory, in that
//   order, and hands the totals to every block, which mixes them into groups
//   (E[x^2] - mu^2 clamped at 0, as _gn_normalize);
//   each block normalizes its rows, applies swish and writes int8, reading
//   its slab from shared memory where the plan holds it (one HBM read of the
//   input), else again from L2.
// What bounds it on the H100: the apply pass's f32 work (gn_epilogue.cuh),
// at 15 to 33% of the bytes bound at the serving shapes (PERF.md).
// Maps of 4^2 and 8^2 have one or two windows an image, so they run one or
// two blocks per image, and a block's fixed latency (constant loads, the
// bulk copy's round trip, two cluster barriers) sets their time.
#include "gn_epilogue.cuh"

using namespace adm;

extern "C" int adm_epilogue_gn_swish_quant(const void* x, int x_is_int32, const void* inv_ws,
                                           const void* zcbias, const void* temb, const void* gn_scale,
                                           const void* gn_bias, const void* act_scale,
                                           const void* act_zp, void* out, int B, int HW, int N,
                                           int groups, int n_levels, float inv_count, int cluster, int wpb,
                                           int threads, int smem, int held, void* stream) {
  EpiArgs a = {};
  a.x = x;
  a.inv_ws = static_cast<const float*>(inv_ws);
  a.zcbias = static_cast<const float*>(zcbias);
  a.temb = static_cast<const float*>(temb);
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  a.act_scale = static_cast<const float*>(act_scale);
  a.act_zp = static_cast<const float*>(act_zp);
  a.out = static_cast<int8_t*>(out);
  a.B = B; a.HW = HW; a.N = N; a.G = groups; a.n_levels = n_levels; a.wpb = wpb; a.inv_count = inv_count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_int32) return (int)launch_k2<int32_t>(a, cluster, threads, smem, held, s);
  return (int)launch_k2<__nv_bfloat16>(a, cluster, threads, smem, held, s);
}
