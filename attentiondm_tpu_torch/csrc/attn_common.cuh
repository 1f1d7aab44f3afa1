// Shared device code of the attention kernels (K3 int8_attention.cu, K8 / K9 /
// K10 int8_attn_core.cu, K11 flash_attention.cu): warp reductions and the
// per-image dynamic int8 quantization of q and k.
//
// The dynamic quantization replaces `_dyn_quant_i8` of
// attentiondm_tpu/ops/int8_attention.py, which ran inside the TPU kernels on a
// whole image held in VMEM.  Here the absolute maximum of an image (L * C
// values) has to be known before any query tile can start, so it is a
// pre-pass of its own: `absmax_kernel` (a maximum, exact in any order; the
// blocks of an image meet in one atomicMax on the value's bit pattern, which
// orders non-negative floats as integers), then `dyn_quant_kernel`:
// s = max(absmax, 1e-12) / 127 and clip(round(x / s), -127, 127), both true
// divisions.  x is the projection's int32 accumulator dequantized in flight
// (x * inv_ws + zcbias, product rounded before the sum: -fmad=false), or an
// f32 tensor as it is.
#pragma once

#include "common.cuh"

namespace adm {

static __device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c (16 x 8 s32) += a (16 x 32 s8, row) . b (32 x 8 s8, col), the integer logits of K8 / K9 / K10
static __device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int PRE_THREADS = 256;

// the value a projection hands to the attention core: its dequantized
// accumulator, or (inv_ws == nullptr) the f32 tensor itself
template <typename T>
static __device__ __forceinline__ float proj_value(const T* x, long long i, const float* inv_ws,
                                                   const float* zcbias, int c) {
  const float v = to_f32(x[i]);
  return inv_ws ? v * inv_ws[c] + zcbias[c] : v;
}

// the symmetric int8 scale of an image from its absolute maximum's bits
static __device__ __forceinline__ float dyn_scale(unsigned amax_bits) {
  return fmaxf(__uint_as_float(amax_bits), 1e-12f) / 127.0f;
}

// amax[b * 2 + slot] = max |value| over image b (the caller zeroes amax)
template <typename T>
__global__ void __launch_bounds__(PRE_THREADS)
absmax_kernel(const T* __restrict__ x, const float* __restrict__ inv_ws, const float* __restrict__ zcbias,
              unsigned* __restrict__ amax, int slot, int n_img, int C) {
  __shared__ float wm[PRE_THREADS / 32];
  const long long base = (long long)blockIdx.y * n_img;
  float m = 0.f;
  for (int i = blockIdx.x * PRE_THREADS + threadIdx.x; i < n_img; i += gridDim.x * PRE_THREADS)
    m = fmaxf(m, fabsf(proj_value(x, base + i, inv_ws, zcbias, i % C)));
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) wm[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < PRE_THREADS / 32; ++w) m = fmaxf(m, wm[w]);
    atomicMax(amax + blockIdx.y * 2 + slot, __float_as_uint(m));
  }
}

// out = clip(round(value / s), -127, 127) at the image's scale s
template <typename T>
__global__ void __launch_bounds__(PRE_THREADS)
dyn_quant_kernel(const T* __restrict__ x, const float* __restrict__ inv_ws, const float* __restrict__ zcbias,
                 const unsigned* __restrict__ amax, int slot, int8_t* __restrict__ out, int n_img, int C) {
  const float s = dyn_scale(amax[blockIdx.y * 2 + slot]);
  const long long base = (long long)blockIdx.y * n_img;
  for (int i = blockIdx.x * PRE_THREADS + threadIdx.x; i < n_img; i += gridDim.x * PRE_THREADS) {
    const float q = rintf(proj_value(x, base + i, inv_ws, zcbias, i % C) / s);
    out[base + i] = (int8_t)__float2int_rn(fminf(fmaxf(q, -127.f), 127.f));
  }
}

static inline dim3 pre_grid(int n_img, int B) {
  const int per_block = PRE_THREADS * 8;
  int nb = (n_img + per_block - 1) / per_block;
  return dim3(nb < 64 ? nb : 64, B);
}

// q and k of every image -> int8 at their own per-image scales; amax [B, 2]
// (q, k) arrives zeroed and leaves holding the maxima's bits
template <typename T>
static cudaError_t launch_dyn_quant_qk(const T* q, const float* iw_q, const float* zc_q, const T* k,
                                       const float* iw_k, const float* zc_k, unsigned* amax, int8_t* q8,
                                       int8_t* k8, int B, int L, int C, cudaStream_t s) {
  const int n_img = L * C;
  const dim3 grid = pre_grid(n_img, B);
  absmax_kernel<T><<<grid, PRE_THREADS, 0, s>>>(q, iw_q, zc_q, amax, 0, n_img, C);
  absmax_kernel<T><<<grid, PRE_THREADS, 0, s>>>(k, iw_k, zc_k, amax, 1, n_img, C);
  dyn_quant_kernel<T><<<grid, PRE_THREADS, 0, s>>>(q, iw_q, zc_q, amax, 0, q8, n_img, C);
  dyn_quant_kernel<T><<<grid, PRE_THREADS, 0, s>>>(k, iw_k, zc_k, amax, 1, k8, n_img, C);
  return cudaGetLastError();
}

}  // namespace adm
