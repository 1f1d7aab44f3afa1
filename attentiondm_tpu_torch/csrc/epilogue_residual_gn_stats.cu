// K7: the resblock exit fused with the next block's GroupNorm statistics
// (`boundary_fusion`): residual' = x_res + (dot * inv_ws + zcbias), written
// at the stream dtype, plus the per-(image, group) sum and sum of squares of
// the f32 residual' (before that rounding) as sums [B, 2, G].
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py
// epilogue_residual_gn_stats (_epi_res_stats_kernel), a block of whole
// images in VMEM.  Nothing here needs the image on chip: one block per
// image walks it once, each element read once from dot and x_res, written
// once, and added into its channel's sums on the way, in the fixed windowed
// order of common.cuh (no float atomics, so the sums are the same bits in
// every run and equal the plain version's).
// What bounds it on the H100: device-memory bytes, 2 or 4 B per element
// from each input and 2 or 4 B out.  One block per image (128 blocks for
// 132 SMs at CIFAR's batch, 32 at church's) and scalar accesses; splitting
// an image over blocks with per-chunk partial sums, as K6 does, is later
// work.
#include "common.cuh"

using namespace adm;

static __device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }
static __device__ __forceinline__ void store_out(float* o, float v) { *o = v; }

template <typename Tdot, typename Tres, typename Tout>
__global__ void __launch_bounds__(1024)
epi_res_stats_kernel(const Tdot* __restrict__ dot, const float* __restrict__ inv_ws,
                     const float* __restrict__ zcbias, const Tres* __restrict__ x_res,
                     Tout* __restrict__ out, float* __restrict__ sums, int HW, int N, int G) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, c = threadIdx.x % N;
  const long long base = (long long)b * HW * N;
  const float iw = inv_ws[c], zc = zcbias[c];
  auto h_at = [&](int p, int cc) {
    const long long o = base + (long long)p * N + cc;
    const float r = to_f32(x_res[o]) + (to_f32(dot[o]) * iw + zc);
    store_out(out + o, r);
    return r;
  };
  float sg, s2g;
  block_gn_sums(h_at, HW, N, G, smem, sg, s2g);
  if ((int)threadIdx.x < G) {
    sums[((long long)b * 2) * G + threadIdx.x] = sg;
    sums[((long long)b * 2 + 1) * G + threadIdx.x] = s2g;
  }
}

template <typename Tdot, typename Tres, typename Tout>
static cudaError_t launch_k7(const void* dot, const float* iw, const float* zc, const void* res, void* out,
                             float* sums, int B, int HW, int N, int G, cudaStream_t s) {
  const Tdot* d = static_cast<const Tdot*>(dot);
  const Tres* r = static_cast<const Tres*>(res);
  Tout* o = static_cast<Tout*>(out);
  return launch_gn_image_kernel(epi_res_stats_kernel<Tdot, Tres, Tout>, B, N, s, d, iw, zc, r, o, sums, HW, N, G);
}

template <typename Tdot, typename Tres>
static cudaError_t launch_k7_out(int out_is_f32, const void* dot, const float* iw, const float* zc,
                                 const void* res, void* out, float* sums, int B, int HW, int N, int G,
                                 cudaStream_t s) {
  if (out_is_f32) return launch_k7<Tdot, Tres, float>(dot, iw, zc, res, out, sums, B, HW, N, G, s);
  return launch_k7<Tdot, Tres, __nv_bfloat16>(dot, iw, zc, res, out, sums, B, HW, N, G, s);
}

extern "C" int adm_epilogue_residual_gn_stats(const void* dot, int dot_is_int32, const void* inv_ws,
                                              const void* zcbias, const void* x_res, int res_is_f32,
                                              void* out, int out_is_f32, void* sums, int B, int HW, int N,
                                              int groups, void* stream) {
  if (N > 1024 || groups > 32 || N % groups != 0 || HW > GN_WIN * GN_WIN * GN_CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *iw = static_cast<const float*>(inv_ws), *zc = static_cast<const float*>(zcbias);
  float* sm = static_cast<float*>(sums);
  if (dot_is_int32) {
    if (res_is_f32) return (int)launch_k7_out<int32_t, float>(out_is_f32, dot, iw, zc, x_res, out, sm, B, HW, N, groups, s);
    return (int)launch_k7_out<int32_t, __nv_bfloat16>(out_is_f32, dot, iw, zc, x_res, out, sm, B, HW, N, groups, s);
  }
  if (res_is_f32) return (int)launch_k7_out<__nv_bfloat16, float>(out_is_f32, dot, iw, zc, x_res, out, sm, B, HW, N, groups, s);
  return (int)launch_k7_out<__nv_bfloat16, __nv_bfloat16>(out_is_f32, dot, iw, zc, x_res, out, sm, B, HW, N, groups, s);
}
