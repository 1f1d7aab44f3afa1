// K6: K2's function -- conv1 epilogue -> +temb -> GroupNorm(32, eps 1e-6) ->
// swish -> int8 -- for images over the whole-image budget: the 256^2 and
// 128^2 resblocks of the LSUN church / bedroom models.
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py
// epilogue_gn_swish_quant_blocked (_epi_stats_kernel + _epi_apply_kernel),
// which split the image into spatial blocks because whole images overflowed
// VMEM, accumulating [B, 2, G] sums across its sequential grid.  Here the
// reason to split is parallelism, and the design is one cooperative launch
// (epi_gn_blocked_kernel in gn_epilogue.cuh, launched as
// ops/fused_gn.epilogue_plan says): resident blocks take (image, chunk of
// GN_CHUNK = 1024 rows) items in image-major order; each sums its chunk per
// channel (8 channels a thread, 16-byte loads) in the windowed f32 order of
// common.cuh, writes the chunk's group sums to partial[B, nchunk, 2, G],
// waits for the image's other chunks on an integer arrival counter, adds the
// partials in chunk order (no float atomics: their order would change from
// run to run), and normalizes, applies swish and writes int8 while its chunk
// is still in L2.  The plain version
// (ops/fused_gn.epilogue_gn_swish_quant_blocked_ref) sums in the same order,
// so the two give the same bits.
// What bounds it on the H100: the apply pass's f32 work (gn_epilogue.cuh),
// at about a third of the bytes bound, one read of the input (2 or 4 B per
// element) and 1 B written (PERF.md).  A chunk (256 KB of bf16) does
// not fit a block's shared memory, so the second read comes from L2 while
// the image's chunks are in flight.
#include "gn_epilogue.cuh"

using namespace adm;

// partial: f32 scratch [B, nchunk, 2, groups]; flags: int32 [B + 1], zeroed
extern "C" int adm_epilogue_gn_swish_quant_blocked(const void* x, int x_is_int32, const void* inv_ws,
                                                   const void* zcbias, const void* temb,
                                                   const void* gn_scale, const void* gn_bias,
                                                   const void* act_scale, const void* act_zp,
                                                   void* partial, void* flags, void* out, int B, int HW,
                                                   int N, int groups, int n_levels, float inv_count,
                                                   int threads, int smem, void* stream) {
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
  a.partial = static_cast<float*>(partial);
  a.flags = static_cast<int*>(flags);
  a.B = B; a.HW = HW; a.N = N; a.G = groups; a.n_levels = n_levels; a.inv_count = inv_count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_int32) return (int)launch_k6<int32_t>(a, threads, smem, s);
  return (int)launch_k6<__nv_bfloat16>(a, threads, smem, s);
}
