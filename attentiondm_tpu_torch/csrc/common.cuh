// Shared device helpers for the serving kernels.
//
// Rounding: the library is compiled with -fmad=false (ops/_build.py), so
// `s * x - z` rounds the product before the subtraction, as torch's plain
// versions and JAX do; rintf rounds half to even like torch.round /
// jnp.round.  FMAs are written out (fmaf) where a kernel wants one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace adm {

// clip(round(s * x - z), -n, n - 1) -> int8 (asymmetric per-channel quant)
static __device__ __forceinline__ int8_t quant_i8(float x, float s, float z, int n) {
  float q = rintf(s * x - z);
  q = fminf(fmaxf(q, (float)(-n)), (float)(n - 1));
  return (int8_t)__float2int_rn(q);
}

// x * sigmoid(x), sigmoid as 1 / (1 + exp(-x))
static __device__ __forceinline__ float swishf(float x) {
  return x * (1.0f / (1.0f + expf(-x)));
}

static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ float to_f32(int32_t v) { return __int2float_rn(v); }
static __device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
static __device__ __forceinline__ float to_f32(float v) { return v; }

// GroupNorm statistics, in the TPU kernel's _gn_normalize form: per-group
// sum S and sum of squares S2 in f32, mean = S/n, var = max(S2/n - mean^2,
// 0), rstd = 1/sqrt(var + eps).
//
// The f32 sums follow one fixed order, the windowed order of XLA's CPU
// reduction: over the rows of a channel, windows of GN_WIN consecutive rows
// are summed in sequence, then the window sums in sequence (recursively, so
// a chunk of GN_CHUNK = 32 * 32 rows is one level-2 window); then the
// channel sums of a group in sequence.  The plain versions
// (ops/fused_gn.window_sum) sum in the same order, so kernel and plain
// version give the same bits on the card, whatever the thread layout.
// Across the UNet's chained quantizers one flipped int8 code grows into a
// few 1e-2 of the output, so a kernel whose sums ran in another order would
// agree with its plain version only statistically.
constexpr int GN_WIN = 32;
constexpr int GN_CHUNK = GN_WIN * GN_WIN;

// Shared memory that gn_chunk_sums needs (window sums, when a channel has
// more than one thread), plus 2 * N floats for the channel sums.
static inline size_t gn_smem_bytes(int threads, int N) {
  return sizeof(float) * ((threads / N > 1 ? 2 * GN_WIN * N : 0) + 2 * N);
}

// Per-channel f32 sum of h and of h*h over the rows [p0, p1) of one chunk
// (p1 - p0 <= GN_CHUNK), in the windowed order above.  Thread t owns
// channel t % N and windows t / N, t / N + R, ... (R = blockDim.x / N), so a
// warp reads consecutive channels of one row; `win` holds 2 * GN_WIN * N
// floats when R > 1.  Every thread of the block calls it; the sums are
// valid in the threads with t / N == 0.
template <typename F>
__device__ void gn_chunk_sums(F h_at, int p0, int p1, int N, float* win, float& s, float& s2) {
  const int R = blockDim.x / N, c = threadIdx.x % N, r = threadIdx.x / N;
  const int nwin = (p1 - p0 + GN_WIN - 1) / GN_WIN;
  s = 0.f;
  s2 = 0.f;
  for (int w = r; w < nwin; w += R) {
    const int a = p0 + w * GN_WIN, b = min(a + GN_WIN, p1);
    float ws = 0.f, ws2 = 0.f;
#pragma unroll 8
    for (int p = a; p < b; ++p) {
      const float h = h_at(p, c);
      ws += h;
      ws2 += h * h;
    }
    if (R == 1) {  // windows arrive in order: sum them as they come
      s += ws;
      s2 += ws2;
    } else {
      win[w * N + c] = ws;
      win[(GN_WIN + w) * N + c] = ws2;
    }
  }
  if (R > 1) {
    __syncthreads();
    if (r == 0)
      for (int w = 0; w < nwin; ++w) {
        s += win[w * N + c];
        s2 += win[(GN_WIN + w) * N + c];
      }
    __syncthreads();
  }
}

// mean and rstd of one group from its f32 sums
static __device__ __forceinline__ void gn_finalize(float S, float S2, float inv_count, float* mean,
                                                   float* rstd) {
  const float m = S * inv_count;
  const float var = fmaxf(S2 * inv_count - m * m, 0.f);
  *mean = m;
  *rstd = 1.0f / sqrtf(var + 1e-6f);
}

// Group sums from the per-channel sums in red[0:N] (S) and red[N:2N] (S2):
// thread g < G adds its group's channels in sequence.
static __device__ __forceinline__ void gn_group_sums(const float* red, int N, int G, float* sg,
                                                     float* s2g) {
  const int g = threadIdx.x, cg = N / G;
  float a = 0.f, a2 = 0.f;
  for (int cc = g * cg; cc < (g + 1) * cg; ++cc) {
    a += red[cc];
    a2 += red[N + cc];
  }
  *sg = a;
  *s2g = a2;
}

// Per-group f32 sums of one image of HW rows (HW <= GN_WIN * GN_WIN *
// GN_CHUNK): chunk sums add in sequence within windows of GN_WIN chunks, and
// those in sequence; then the channels of a group in sequence.  h_at(p, c)
// yields the value at row p and channel c and is called exactly once per
// element; `smem` holds gn_smem_bytes(blockDim.x, N).  The sums of group g
// land in thread g < G (`sg`, `s2g`); ends with the block in step.
template <typename F>
__device__ void block_gn_sums(F h_at, int HW, int N, int G, float* smem, float& sg, float& s2g) {
  float* red = smem;
  float* win = smem + 2 * N;
  float S = 0.f, S2 = 0.f;
  for (int q0 = 0; q0 < HW; q0 += GN_WIN * GN_CHUNK) {
    float S3 = 0.f, S23 = 0.f;
    for (int p0 = q0; p0 < min(q0 + GN_WIN * GN_CHUNK, HW); p0 += GN_CHUNK) {
      float cs, cs2;
      gn_chunk_sums(h_at, p0, min(p0 + GN_CHUNK, HW), N, win, cs, cs2);
      S3 += cs;
      S23 += cs2;
    }
    S += S3;
    S2 += S23;
  }
  if ((int)threadIdx.x < N) {
    red[threadIdx.x] = S;
    red[N + threadIdx.x] = S2;
  }
  __syncthreads();
  sg = 0.f;
  s2g = 0.f;
  if ((int)threadIdx.x < G) gn_group_sums(red, N, G, &sg, &s2g);
  __syncthreads();
}

// GroupNorm statistics of one image: block_gn_sums, finalized into
// mean_g[G] and rstd_g[G].
template <typename F>
__device__ void block_gn_stats(F h_at, int HW, int N, int G, float inv_count, float* smem,
                               float* mean_g, float* rstd_g) {
  float sg, s2g;
  block_gn_sums(h_at, HW, N, G, smem, sg, s2g);
  if ((int)threadIdx.x < G) gn_finalize(sg, s2g, inv_count, &mean_g[threadIdx.x], &rstd_g[threadIdx.x]);
  __syncthreads();
}

// Threads of a one-block-per-image GroupNorm kernel over N channels: thread
// t owns channel t % N, so the block is a multiple of N, the largest up to
// 1024 threads (N <= 1024).  The pass waits on memory, one scalar load a
// thread at a time, so the loads in flight count: on the H100, 1024 threads
// a block nearly halved K2's device time against 512 (PERF.md).
static inline int gn_threads(int N) { return N >= 1024 ? N : 1024 / N * N; }

// The shared pass GroupNorm -> swish or none -> n_out per-channel int8
// quantizations of one image, behind K4 (gn_act_quant.cu), the first launch
// of K3 (int8_attention.cu) and the first and third launches of K12
// (resblock.cu).  K2 and K6 have their own design (gn_epilogue.cuh).
struct GnQuantArgs {
  const float* gn_scale;  // [N]
  const float* gn_bias;   // [N]
  const float* scale[3];  // [N] activation quant scale of output i
  const float* zp[3];     // [N] its zero point
  int8_t* out[3];         // [B, HW, N], or [B, H + 2, W + 2, N] with a halo
  int n_levels[3];        // 2^(a_bit - 1)
  int n_out, swish;
  int HW, N, G;
  float inv_count;
  int halo_w;  // 0: dense rows; W > 0: rows are (y, x) of an H x W image and
               // land at (y + 1, x + 1) of a halo'd image whose border this
               // pass fills with each channel's quantized zero
};

template <bool HALO, typename F>
__device__ void gn_act_quant_image(F h_at, const GnQuantArgs& a, int b, float* smem, float* mean_g,
                                   float* rstd_g) {
  const int N = a.N, HW = a.HW;
  block_gn_stats(h_at, HW, N, a.G, a.inv_count, smem, mean_g, rstd_g);

  const int c = threadIdx.x % N, r0 = threadIdx.x / N, R = blockDim.x / N;
  const int grp = c / (N / a.G);
  const float mu = mean_g[grp], rs = rstd_g[grp], gs = a.gn_scale[c], gb = a.gn_bias[c];
  const int W = HALO ? a.halo_w : 1, Wp = W + 2, Hp = HW / W + 2;
  const long long base = HALO ? (long long)b * Hp * Wp * N : (long long)b * HW * N;
  float s[3], z[3];  // loops over the outputs unroll fully: every index is static
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < a.n_out) {
      s[i] = a.scale[i][c];
      z[i] = a.zp[i][c];
    }
  for (int p = r0; p < HW; p += R) {
    float h = (h_at(p, c) - mu) * rs * gs + gb;
    if (a.swish) h = swishf(h);
    const long long o = base + (HALO ? (long long)((p / W + 1) * Wp + p % W + 1) * N : (long long)p * N) + c;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < a.n_out) a.out[i][o] = quant_i8(h, s[i], z[i], a.n_levels[i]);
  }
  if (HALO)  // halo: clip(round(-zp), -n, n - 1), the code that decodes to 0.0
    for (int q = r0; q < Hp * Wp; q += R) {
      const int y = q / Wp, x = q - y * Wp;
      if (y == 0 || y == Hp - 1 || x == 0 || x == Wp - 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (i < a.n_out) {
            const float n = (float)a.n_levels[i];
            a.out[i][base + (long long)q * N + c] =
                (int8_t)__float2int_rn(fminf(fmaxf(rintf(-z[i]), -n), n - 1.f));
          }
      }
    }
}

// GroupNorm -> act -> quant of a float image x [B, HW, N] (K4's kernel).
// The launch bound is 1024 threads (64 registers a thread) at every width:
// bounded at 512 threads where N <= 512, the same kernels ran slower on the
// H100 (PERF.md).
template <typename Tin, bool HALO>
__global__ void __launch_bounds__(1024) gn_act_quant_kernel(const Tin* __restrict__ x, GnQuantArgs a) {
  extern __shared__ float smem[];
  __shared__ float mean_g[32], rstd_g[32];
  const long long base = (long long)blockIdx.x * a.HW * a.N;
  auto h_at = [&](int p, int c) { return to_f32(x[base + (long long)p * a.N + c]); };
  gn_act_quant_image<HALO>(h_at, a, blockIdx.x, smem, mean_g, rstd_g);
}

template <typename K, typename... Args>
static cudaError_t launch_gn_image_kernel(K kernel, int B, int N, cudaStream_t s, Args... args) {
  const int threads = gn_threads(N);
  const size_t smem = gn_smem_bytes(threads, N);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename Tin>
static cudaError_t launch_gn_act_quant(const Tin* x, const GnQuantArgs& a, int B, cudaStream_t s) {
  if (a.N > 1024 || a.G > 32 || a.N % a.G != 0 || a.n_out < 1 || a.n_out > 3 ||
      a.HW > GN_WIN * GN_WIN * GN_CHUNK || (a.halo_w && a.HW % a.halo_w != 0))
    return cudaErrorInvalidValue;
  if (a.halo_w) return launch_gn_image_kernel(gn_act_quant_kernel<Tin, true>, B, a.N, s, x, a);
  return launch_gn_image_kernel(gn_act_quant_kernel<Tin, false>, B, a.N, s, x, a);
}

// K12's third launch (resblock.cu): h = x * inv_ws + zcbias + temb (x the
// conv's int32 accumulator, or bf16 / f32 already dequantized), then the
// shared pass into a halo'd buffer
template <typename Tin, bool HALO>
__global__ void __launch_bounds__(1024)
epi_gn_swish_quant_kernel(const Tin* __restrict__ x, const float* __restrict__ inv_ws,
                          const float* __restrict__ zcbias, const float* __restrict__ temb,
                          GnQuantArgs a) {
  extern __shared__ float smem[];
  __shared__ float mean_g[32], rstd_g[32];
  const int b = blockIdx.x, c = threadIdx.x % a.N;
  const long long base = (long long)b * a.HW * a.N;
  const float iw = inv_ws[c], zc = zcbias[c], te = temb[(long long)b * a.N + c];
  auto h_at = [&](int p, int cc) { return to_f32(x[base + (long long)p * a.N + cc]) * iw + zc + te; };
  gn_act_quant_image<HALO>(h_at, a, b, smem, mean_g, rstd_g);
}

template <typename Tin>
static cudaError_t launch_epi_gn_swish_quant(const Tin* x, const float* inv_ws, const float* zcbias,
                                             const float* temb, const GnQuantArgs& a, int B,
                                             cudaStream_t s) {
  if (a.N > 1024 || a.G > 32 || a.N % a.G != 0 || a.n_out != 1 || a.HW > GN_WIN * GN_WIN * GN_CHUNK ||
      (a.halo_w && a.HW % a.halo_w != 0))
    return cudaErrorInvalidValue;
  if (a.halo_w)
    return launch_gn_image_kernel(epi_gn_swish_quant_kernel<Tin, true>, B, a.N, s, x, inv_ws, zcbias, temb, a);
  return launch_gn_image_kernel(epi_gn_swish_quant_kernel<Tin, false>, B, a.N, s, x, inv_ws, zcbias, temb, a);
}

}  // namespace adm
