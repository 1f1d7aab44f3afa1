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
// group g < G adds its channels in sequence.
static __device__ __forceinline__ void gn_group_sums(const float* red, int N, int G, int g, float* sg,
                                                     float* s2g) {
  const int cg = N / G;
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
  if ((int)threadIdx.x < G) gn_group_sums(red, N, G, threadIdx.x, &sg, &s2g);
  __syncthreads();
}

// The one-block-per-image GroupNorm pass, K7's (epilogue_residual_gn_stats.cu);
// the other GroupNorm kernels run on gn_epilogue.cuh.
// Threads of a one-block-per-image GroupNorm kernel over N channels: thread
// t owns channel t % N, so the block is a multiple of N, the largest up to
// 1024 threads (N <= 1024).  The pass waits on memory, one scalar load a
// thread at a time, so the loads in flight count: on the H100, 1024 threads
// a block nearly halved the pass's device time against 512 (PERF.md).
static inline int gn_threads(int N) { return N >= 1024 ? N : 1024 / N * N; }

template <typename K, typename... Args>
static cudaError_t launch_gn_image_kernel(K kernel, int B, int N, cudaStream_t s, Args... args) {
  const int threads = gn_threads(N);
  const size_t smem = gn_smem_bytes(threads, N);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace adm
