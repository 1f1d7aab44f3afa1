// K6: K2's function -- conv1 epilogue -> +temb -> GroupNorm(32, eps 1e-6) ->
// swish -> int8 -- for images too large for one block to own: the 256^2
// and 128^2 resblocks of the LSUN church / bedroom models.
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py
// epilogue_gn_swish_quant_blocked (_epi_stats_kernel + _epi_apply_kernel),
// which split the image into spatial blocks because whole images overflowed
// VMEM, accumulating [B, 2, G] sums across its sequential grid.  Here the
// reason to split is parallelism: one block per image (K2) gives 32 blocks
// for 132 SMs at batch 32, each reading 16 MB twice.  So the grid is
// (image, chunk of GN_CHUNK = 1024 rows):
//   pass 1 (stats): each block sums its chunk per channel in the windowed
//   f32 order of common.cuh, mixes the channel sums into its groups and
//   writes them to partial[B, nchunk, 2, G];
//   pass 2 (apply): each block first adds its image's nchunk partials in
//   chunk order, in f32 (no float atomics: their order would change from run
//   to run), finalizes mean / rstd, then normalizes its chunk, applies swish
//   and writes int8.
// The plain version (ops/fused_gn.epilogue_gn_swish_quant_blocked_ref) sums
// in the same order, so the two give the same bits.
// What bounds it on the H100: device-memory bytes, 2 reads of the input (2
// or 4 B per element) and 1 B written; at 256^2, batch 32 the input is
// 537 MB, far beyond the 50 MB L2, so pass 2 reads it again from HBM.
// Scalar loads (64 B per warp for bf16) and no reuse of pass 1's read are
// what a faster version would change.
#include "common.cuh"

using namespace adm;

static inline int k6_threads(int N) { return N * (N < 512 ? 512 / N : 1); }

template <typename Tin>
__global__ void __launch_bounds__(1024)
epi_gn_stats_blocked_kernel(const Tin* __restrict__ x, const float* __restrict__ inv_ws,
                            const float* __restrict__ zcbias, const float* __restrict__ temb,
                            float* __restrict__ partial, int HW, int N, int G) {
  extern __shared__ float smem[];
  float* red = smem;
  float* win = smem + 2 * N;
  const int k = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int c = threadIdx.x % N;
  const long long base = (long long)b * HW * N;
  const float iw = inv_ws[c], zc = zcbias[c], te = temb[(long long)b * N + c];
  auto h_at = [&](int p, int cc) { return to_f32(x[base + (long long)p * N + cc]) * iw + zc + te; };

  float s, s2;
  gn_chunk_sums(h_at, k * GN_CHUNK, min((k + 1) * GN_CHUNK, HW), N, win, s, s2);
  if ((int)threadIdx.x < N) {
    red[threadIdx.x] = s;
    red[N + threadIdx.x] = s2;
  }
  __syncthreads();
  if ((int)threadIdx.x < G) {
    float sg, s2g;
    gn_group_sums(red, N, G, &sg, &s2g);
    float* p = partial + ((long long)b * nchunk + k) * 2 * G;
    p[threadIdx.x] = sg;
    p[G + threadIdx.x] = s2g;
  }
}

template <typename Tin>
__global__ void __launch_bounds__(1024)
epi_gn_apply_blocked_kernel(const Tin* __restrict__ x, const float* __restrict__ inv_ws,
                            const float* __restrict__ zcbias, const float* __restrict__ temb,
                            const float* __restrict__ partial, const float* __restrict__ gn_scale,
                            const float* __restrict__ gn_bias, const float* __restrict__ act_scale,
                            const float* __restrict__ act_zp, int8_t* __restrict__ out, int HW, int N,
                            int G, int n_levels, float inv_count) {
  __shared__ float mean_g[32], rstd_g[32];
  const int k = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  if ((int)threadIdx.x < G) {
    const float* p = partial + (long long)b * nchunk * 2 * G;
    float S = 0.f, S2 = 0.f;
    for (int j = 0; j < nchunk; ++j) {
      S += p[j * 2 * G + threadIdx.x];
      S2 += p[j * 2 * G + G + threadIdx.x];
    }
    gn_finalize(S, S2, inv_count, &mean_g[threadIdx.x], &rstd_g[threadIdx.x]);
  }
  __syncthreads();

  const int c = threadIdx.x % N, r0 = threadIdx.x / N, R = blockDim.x / N;
  const long long base = (long long)b * HW * N;
  const float iw = inv_ws[c], zc = zcbias[c], te = temb[(long long)b * N + c];
  const int grp = c / (N / G);
  const float mu = mean_g[grp], rs = rstd_g[grp];
  const float gs = gn_scale[c], gb = gn_bias[c], s = act_scale[c], z = act_zp[c];
  const int p1 = min((k + 1) * GN_CHUNK, HW);
  for (int p = k * GN_CHUNK + r0; p < p1; p += R) {
    const long long o = base + (long long)p * N + c;
    const float h = ((to_f32(x[o]) * iw + zc + te) - mu) * rs * gs + gb;
    out[o] = quant_i8(swishf(h), s, z, n_levels);
  }
}

template <typename Tin>
static cudaError_t launch_k6(const Tin* x, const float* const* f, float* partial, int8_t* out, int B,
                             int HW, int N, int G, int n_levels, float inv_count, cudaStream_t s) {
  const int threads = k6_threads(N), nchunk = (HW + GN_CHUNK - 1) / GN_CHUNK;
  const size_t smem = gn_smem_bytes(threads, N);
  cudaError_t err = cudaFuncSetAttribute(epi_gn_stats_blocked_kernel<Tin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nchunk, B);
  epi_gn_stats_blocked_kernel<Tin><<<grid, threads, smem, s>>>(x, f[0], f[1], f[2], partial, HW, N, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  epi_gn_apply_blocked_kernel<Tin><<<grid, threads, 0, s>>>(x, f[0], f[1], f[2], partial, f[3], f[4], f[5],
                                                            f[6], out, HW, N, G, n_levels, inv_count);
  return cudaGetLastError();
}

// partial: f32 scratch of B * ceil(HW / 1024) * 2 * groups floats
extern "C" int adm_epilogue_gn_swish_quant_blocked(const void* x, int x_is_int32, const void* inv_ws,
                                                   const void* zcbias, const void* temb,
                                                   const void* gn_scale, const void* gn_bias,
                                                   const void* act_scale, const void* act_zp,
                                                   void* partial, void* out, int B, int HW, int N,
                                                   int groups, int n_levels, float inv_count,
                                                   void* stream) {
  if (N % 128 != 0 || N > 1024 || groups > 32 || N % groups != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[7] = {static_cast<const float*>(inv_ws), static_cast<const float*>(zcbias),
                       static_cast<const float*>(temb), static_cast<const float*>(gn_scale),
                       static_cast<const float*>(gn_bias), static_cast<const float*>(act_scale),
                       static_cast<const float*>(act_zp)};
  float* pt = static_cast<float*>(partial);
  int8_t* o = static_cast<int8_t*>(out);
  if (x_is_int32)
    return (int)launch_k6(static_cast<const int32_t*>(x), f, pt, o, B, HW, N, groups, n_levels, inv_count, s);
  return (int)launch_k6(static_cast<const __nv_bfloat16*>(x), f, pt, o, B, HW, N, groups, n_levels, inv_count,
                        s);
}
