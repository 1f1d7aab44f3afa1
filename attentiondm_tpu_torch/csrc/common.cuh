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
// 0), rstd = 1/sqrt(var + eps), eps the model's (1e-6 the DDPM UNet's, 1e-5
// ADM's), handed in by every launcher.
//
// The f32 sums follow one fixed order, the windowed order of XLA's CPU
// reduction: over the rows of a channel, windows of GN_WIN consecutive rows
// are summed in sequence, then the window sums in sequence (recursively, so
// a chunk of GN_CHUNK = 32 * 32 rows is one level-2 window); then the
// channel sums of a group in sequence.  The plain versions
// (ops/fused_gn.window_sum) sum in the same order, so kernel and plain
// version give the same bits on the card, whatever the thread layout
// (gn_epilogue.cuh splits an image across threads and blocks by whole
// windows, chunks and groups).
// Across the UNet's chained quantizers one flipped int8 code grows into a
// few 1e-2 of the output, so a kernel whose sums ran in another order would
// agree with its plain version only statistically.
constexpr int GN_WIN = 32;
constexpr int GN_CHUNK = GN_WIN * GN_WIN;

// mean and rstd of one group from its f32 sums
static __device__ __forceinline__ void gn_finalize(float S, float S2, float inv_count, float eps, float* mean,
                                                   float* rstd) {
  const float m = S * inv_count;
  const float var = fmaxf(S2 * inv_count - m * m, 0.f);
  *mean = m;
  *rstd = 1.0f / sqrtf(var + eps);
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

}  // namespace adm
