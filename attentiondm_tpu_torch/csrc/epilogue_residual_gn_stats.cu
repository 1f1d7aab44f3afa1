// K7: the resblock exit fused with the next block's GroupNorm statistics
// (`boundary_fusion`): residual' = x_res + (dot * inv_ws + zcbias), written
// at the stream dtype, plus the per-(image, group) sum and sum of squares of
// the f32 residual' (before that rounding) as sums [B, 2, G].
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py
// epilogue_residual_gn_stats (_epi_res_stats_kernel), a block of whole
// images in VMEM.  Nothing here needs the image on chip: each element is
// read once from dot and x_res, written once, and added into its channel's
// sums on the way, in the fixed windowed order of window_sum (no float
// atomics, so the sums are the same bits in every run and equal the plain
// version's).
// What bounds it on the H100: device-memory bytes, 2 or 4 B an element from
// each input and 2 or 4 B out (6 B on the serving path: bf16 conv2 output,
// bf16 residual, bf16 out), and on the 4^2 and 8^2 maps the latency of a
// window's 32 rows, which one thread adds in sequence.  It runs on
// gn_epilogue.cuh's image form (res_gn_stats_kernel): a block an image or a
// slice of whole groups, a row group a window, 8, 4 or 2 channels a thread
// (16-, 8- or 4-byte loads of bf16), as ops/fused_gn.epilogue_plan(...,
// "K7") plans it.
#include "gn_epilogue.cuh"

using namespace adm;

template <typename Tdot, typename Tres>
static cudaError_t launch_out(const ResArgs& a, int out_is_f32, const GnPlan& p, int vec, cudaStream_t s) {
  if (out_is_f32) return launch_k7<Tdot, Tres, float>(a, p, vec, s);
  return launch_k7<Tdot, Tres, __nv_bfloat16>(a, p, vec, s);
}

// plan: ops/fused_gn.plan_args of epilogue_plan(..., "K7"); vec: its channels a thread
extern "C" int adm_epilogue_residual_gn_stats(const void* dot, int dot_is_int32, const void* inv_ws,
                                              const void* zcbias, const void* x_res, int res_is_f32,
                                              void* out, int out_is_f32, void* sums, int B, int HW, int N,
                                              int groups, const int* plan, int vec, void* stream) {
  ResArgs a = {};
  a.dot = dot;
  a.x_res = x_res;
  a.inv_ws = static_cast<const float*>(inv_ws);
  a.zcbias = static_cast<const float*>(zcbias);
  a.out = out;
  a.sums = static_cast<float*>(sums);
  a.B = B; a.HW = HW; a.N = N; a.G = groups;
  const GnPlan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dot_is_int32)
    err = res_is_f32 ? launch_out<int32_t, float>(a, out_is_f32, p, vec, s)
                     : launch_out<int32_t, __nv_bfloat16>(a, out_is_f32, p, vec, s);
  else
    err = res_is_f32 ? launch_out<__nv_bfloat16, float>(a, out_is_f32, p, vec, s)
                     : launch_out<__nv_bfloat16, __nv_bfloat16>(a, out_is_f32, p, vec, s);
  return (int)err;
}
