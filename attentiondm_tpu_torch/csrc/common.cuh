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

// GroupNorm statistics of one image of HW rows (HW <= GN_WIN * GN_WIN *
// GN_CHUNK): chunk sums add in sequence within windows of GN_WIN chunks, and
// those in sequence.  h_at(p, c) yields the value at row p and channel c;
// `smem` holds gn_smem_bytes(blockDim.x, N); the results land in mean_g[G]
// and rstd_g[G].
template <typename F>
__device__ void block_gn_stats(F h_at, int HW, int N, int G, float inv_count, float* smem,
                               float* mean_g, float* rstd_g) {
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
  if ((int)threadIdx.x < G) {
    float sg, s2g;
    gn_group_sums(red, N, G, &sg, &s2g);
    gn_finalize(sg, s2g, inv_count, &mean_g[threadIdx.x], &rstd_g[threadIdx.x]);
  }
  __syncthreads();
}

}  // namespace adm
