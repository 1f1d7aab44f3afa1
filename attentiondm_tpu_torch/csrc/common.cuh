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

// GroupNorm statistics of one image, in the TPU kernel's _gn_normalize form:
// per-group sum S and sum of squares S2, mean = S/n, var = max(S2/n -
// mean^2, 0), rstd = 1/sqrt(var + eps), all in f32.  S and S2 accumulate in
// f64 and round once to f32, so they do not depend on the summation order
// (f32 products of f32 values are exact in f64): the plain versions
// (ops/fused_gn.gn_normalize) sum in f64 too and get the same f32 bits.
// An f32 order difference would flip a few int8 codes, and through the
// serving UNet's ~60 chained quantizers such flips grow into a few 1e-2 of
// the output, which would hide the kernels' agreement with their plain
// versions.
//
// h_at(p, c) yields the value at spatial row p and channel c.  Thread t owns
// channel t % N and rows t / N, t / N + R, ... (R = blockDim.x / N), so a
// warp reads consecutive channels of one row.  `red` holds 2 * blockDim.x
// doubles of shared memory; the results land in mean_g[G] and rstd_g[G].
template <typename F>
__device__ void block_gn_stats(F h_at, int HW, int N, int G, float inv_count, double* red,
                               float* mean_g, float* rstd_g) {
  const int tid = threadIdx.x, R = blockDim.x / N;
  const int c = tid % N, r0 = tid / N;
  double s = 0.0, s2 = 0.0;
  for (int p = r0; p < HW; p += R) {
    const double h = h_at(p, c);
    s += h;
    s2 += h * h;
  }
  red[tid] = s;
  red[blockDim.x + tid] = s2;
  __syncthreads();
  if (tid < G) {
    const int cg = N / G;
    double sg = 0.0, s2g = 0.0;
    for (int cc = tid * cg; cc < (tid + 1) * cg; ++cc) {
      for (int r = 0; r < R; ++r) {
        sg += red[r * N + cc];
        s2g += red[blockDim.x + r * N + cc];
      }
    }
    const float mean = (float)sg * inv_count;
    const float var = fmaxf((float)s2g * inv_count - mean * mean, 0.f);
    mean_g[tid] = mean;
    rstd_g[tid] = 1.0f / sqrtf(var + 1e-6f);
  }
  __syncthreads();
}

}  // namespace adm
