// K2: fused conv1 epilogue -> +temb -> GroupNorm(32, eps 1e-6) -> swish ->
// per-channel asymmetric int8 quant, the middle of every serving resblock.
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py
// epilogue_gn_swish_quant (_epi_gn_quant_kernel), which held whole images
// in VMEM.  One CIFAR level-0 image is 32*32*128*2 B = 256 KB of bf16, more
// than a Hopper block's 227 KB of shared memory, so this kernel keeps
// nothing but the statistics on chip:
//   one block per image;
//   pass 1 reads the image once, accumulating per-channel sum and sum of
//   squares (registers, then shared memory), and mixes them into groups
//   (E[x^2] - mu^2 clamped at 0 in f32, as _gn_normalize; the sums
//   accumulate in f64, see common.cuh);
//   pass 2 reads the image again (it mostly hits the 50 MB L2), normalizes,
//   applies swish and writes int8.
// What bounds it on the H100: device-memory bytes, about 2 B in and 1 B out
// per element plus the L2 re-read; 128 images give about one wave on 132
// SMs.  Vector loads and several images per SM are later work.
#include "common.cuh"

using namespace adm;

constexpr int GN_THREADS = 512;

template <typename Tin>
__global__ void __launch_bounds__(GN_THREADS)
epi_gn_swish_quant_kernel(const Tin* __restrict__ x, const float* __restrict__ inv_ws,
                          const float* __restrict__ zcbias, const float* __restrict__ temb,
                          const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
                          const float* __restrict__ act_scale, const float* __restrict__ act_zp,
                          int8_t* __restrict__ out, int HW, int N, int G, int n_levels,
                          float inv_count) {
  __shared__ double red[2 * GN_THREADS];
  __shared__ float mean_g[32], rstd_g[32];
  const int b = blockIdx.x;
  const int c = threadIdx.x % N, r0 = threadIdx.x / N, R = blockDim.x / N;
  const long long base = (long long)b * HW * N;
  const float iw = inv_ws[c], zc = zcbias[c], te = temb[(long long)b * N + c];

  auto h_at = [&](int p, int cc) { return to_f32(x[base + (long long)p * N + cc]) * iw + zc + te; };
  block_gn_stats(h_at, HW, N, G, inv_count, red, mean_g, rstd_g);

  const int grp = c / (N / G);
  const float mu = mean_g[grp], rs = rstd_g[grp];
  const float gs = gn_scale[c], gb = gn_bias[c], s = act_scale[c], z = act_zp[c];
  for (int p = r0; p < HW; p += R) {
    const float h = (h_at(p, c) - mu) * rs * gs + gb;
    out[base + (long long)p * N + c] = quant_i8(swishf(h), s, z, n_levels);
  }
}

extern "C" int adm_epilogue_gn_swish_quant(const void* x, int x_is_int32, const void* inv_ws,
                                           const void* zcbias, const void* temb, const void* gn_scale,
                                           const void* gn_bias, const void* act_scale,
                                           const void* act_zp, void* out, int B, int HW, int N,
                                           int groups, int n_levels, float inv_count, void* stream) {
  if (GN_THREADS % N != 0 || groups > 32 || N % groups != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[7] = {static_cast<const float*>(inv_ws), static_cast<const float*>(zcbias),
                       static_cast<const float*>(temb), static_cast<const float*>(gn_scale),
                       static_cast<const float*>(gn_bias), static_cast<const float*>(act_scale),
                       static_cast<const float*>(act_zp)};
  if (x_is_int32)
    epi_gn_swish_quant_kernel<int32_t><<<B, GN_THREADS, 0, s>>>(
        static_cast<const int32_t*>(x), f[0], f[1], f[2], f[3], f[4], f[5], f[6],
        static_cast<int8_t*>(out), HW, N, groups, n_levels, inv_count);
  else
    epi_gn_swish_quant_kernel<__nv_bfloat16><<<B, GN_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), f[0], f[1], f[2], f[3], f[4], f[5], f[6],
        static_cast<int8_t*>(out), HW, N, groups, n_levels, inv_count);
  return (int)cudaGetLastError();
}
