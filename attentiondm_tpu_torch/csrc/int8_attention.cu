// K3: the whole DDIM attention block with int8 projections.
//
// Replaces the TPU kernel attentiondm_tpu/ops/int8_attention.py
// fused_attention_block (_attn_block_kernel), one program per batch block
// with everything in VMEM.  One image's f32 logits (L*L*4 B = 256 KB at
// L = 256) exceed a Hopper block's shared memory, so here the block is a
// chain of four launches behind one C entry point, in the TPU kernel's
// order of operations:
//   1. gn_quant3: GroupNorm statistics and normalize of the bf16 residual,
//      one block per image, written as three int8 tensors at the q / k / v
//      input quant scales;
//   2. the q / k / v 1x1 projections: the int8 implicit GEMM of K1
//      (igemm.cuh) with an f32 dequant epilogue;
//   3. attn_core: f32 logits (q k^T, then * C^-1/2), softmax (max, exp,
//      divide by the sum) and AV for a 16-query tile per block, logits in
//      shared memory, then the int8 quant of proj_out's input;
//   4. the output projection: the int8 GEMM with a dequant + residual-add
//      epilogue, written at the residual's dtype (bf16).
// The core's three sums (q.k, the softmax denominator, p.v) accumulate in
// f64 and round once to f32, like the GroupNorm sums (common.cuh): every
// value stays the f32 the TPU kernel computes, but independent of the
// summation order, so the plain version (f64 einsum, then f32) gives the
// same bits and the int8 codes downstream agree exactly.
// What bounds it on the H100: the core runs on the CUDA cores (no TF32),
// 2*L*L*C f64 multiply-adds per image with their operands read from shared
// memory.  Fusing the chain (flash-style, tensor-core f32 emulation or a
// bf16 core with a quality check) is later work.
#include "igemm.cuh"

using namespace adm;

constexpr int AT_THREADS = 256, AT_BQ = 16, AT_TK = 16, GQ_THREADS = 512;

__global__ void __launch_bounds__(GQ_THREADS)
gn_quant3_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gn,
                 const float* __restrict__ sqkv, int nq, int nk, int nv, int8_t* __restrict__ q8,
                 int8_t* __restrict__ k8, int8_t* __restrict__ v8, int L, int C, int G,
                 float inv_count) {
  __shared__ double red[2 * GQ_THREADS];
  __shared__ float mean_g[32], rstd_g[32];
  const long long base = (long long)blockIdx.x * L * C;
  auto h_at = [&](int p, int c) { return to_f32(x[base + (long long)p * C + c]); };
  block_gn_stats(h_at, L, C, G, inv_count, red, mean_g, rstd_g);

  const int c = threadIdx.x % C, r0 = threadIdx.x / C, R = blockDim.x / C;
  const int grp = c / (C / G);
  const float mu = mean_g[grp], rs = rstd_g[grp], gs = gn[c], gb = gn[C + c];
  for (int p = r0; p < L; p += R) {
    const long long o = base + (long long)p * C + c;
    const float h = (h_at(p, c) - mu) * rs * gs + gb;
    q8[o] = quant_i8(h, sqkv[c], sqkv[C + c], nq);
    k8[o] = quant_i8(h, sqkv[2 * C + c], sqkv[3 * C + c], nk);
    v8[o] = quant_i8(h, sqkv[4 * C + c], sqkv[5 * C + c], nv);
  }
}

static __device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C>
__global__ void __launch_bounds__(AT_THREADS)
attn_core_kernel(const float* __restrict__ qf, const float* __restrict__ kf,
                 const float* __restrict__ vf, const float* __restrict__ sqo, int n_o,
                 int8_t* __restrict__ o8, int L, float scale) {
  extern __shared__ double sm[];
  constexpr int LD = C + 1;  // padded rows: conflict-free column walks
  double* Qs = sm;                // [BQ][LD]
  double* Ks = Qs + AT_BQ * LD;   // [TK][LD]
  double* S = Ks + AT_TK * LD;    // [BQ][L] f32 logits, then f32 probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * AT_BQ;
  const float* Q = qf + ((long long)b * L + q0) * C;
  const float* K = kf + (long long)b * L * C;
  const float* V = vf + (long long)b * L * C;

  for (int i = tid; i < AT_BQ * C; i += AT_THREADS) {
    const int r = i / C, cc = i - r * C;
    Qs[r * LD + cc] = (q0 + r < L) ? (double)Q[i] : 0.0;
  }
  // logits: thread -> query qi, key kj of each TK-key tile
  const int qi = tid / AT_TK, kj = tid % AT_TK;
  for (int j0 = 0; j0 < L; j0 += AT_TK) {
    __syncthreads();
    for (int i = tid; i < AT_TK * C; i += AT_THREADS) {
      const int r = i / C, cc = i - r * C;
      Ks[r * LD + cc] = (j0 + r < L) ? (double)K[(long long)(j0 + r) * C + cc] : 0.0;
    }
    __syncthreads();
    double d = 0.0;
#pragma unroll 8
    for (int cc = 0; cc < C; ++cc) d = fma(Qs[qi * LD + cc], Ks[kj * LD + cc], d);
    if (j0 + kj < L) S[qi * L + j0 + kj] = (double)((float)d * scale);
  }
  __syncthreads();
  // softmax, one warp per row: e = exp(l - max) in f32, p = e / (f32 of the f64 sum)
  for (int r = warp; r < AT_BQ; r += AT_THREADS / 32) {
    double* row = S + r * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, (float)row[j]);
    m = warp_max(m);
    double sum = 0.0;
    for (int j = lane; j < L; j += 32) {
      const float e = expf((float)row[j] - m);
      row[j] = e;
      sum += e;
    }
    const float total = (float)warp_sum(sum);
    for (int j = lane; j < L; j += 32) row[j] = (double)((float)row[j] / total);
  }
  __syncthreads();
  // AV: thread -> channel cc, RPT consecutive query rows; then int8 quant
  constexpr int RPT = AT_BQ * C / AT_THREADS;
  const int cc = tid % C, rb = (tid / C) * RPT;
  double acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0;
  for (int j = 0; j < L; ++j) {
    const double vv = V[(long long)j * C + cc];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = fma(S[(rb + r) * L + j], vv, acc[r]);
  }
  const float so = sqo[cc], zo = sqo[C + cc];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    if (q0 + rb + r < L) o8[((long long)b * L + q0 + rb + r) * C + cc] = quant_i8((float)acc[r], so, zo, n_o);
}

template <int C>
static cudaError_t launch_core(const float* qf, const float* kf, const float* vf, const float* sqo,
                               int n_o, int8_t* o8, int B, int L, float scale, cudaStream_t s) {
  const size_t smem = sizeof(double) * ((size_t)(AT_BQ + AT_TK) * (C + 1) + (size_t)AT_BQ * L);
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + AT_BQ - 1) / AT_BQ, B);
  attn_core_kernel<C><<<grid, AT_THREADS, smem, s>>>(qf, kf, vf, sqo, n_o, o8, L, scale);
  return cudaGetLastError();
}

static IgemmArgs proj_args(const void* x8, const void* w, const float* iw, const float* zc, void* out,
                           int B, int L, int C) {
  IgemmArgs a;
  a.x = static_cast<const int8_t*>(x8);
  a.w = static_cast<const int8_t*>(w);
  a.inv_ws = iw;
  a.zcbias = zc;
  a.res = nullptr;
  a.out = out;
  a.B = B; a.Hp = L; a.Wp = 1; a.Cp = C; a.Ho = L; a.Wo = 1; a.Np = C; a.stride = 1;
  return a;
}

extern "C" int adm_fused_attention_block(const void* x, const void* gn, const void* sqkv, int nq, int nk,
                                         int nv, const void* wq, const void* wk, const void* wv,
                                         const void* eqkv, const void* sqo, int n_o, const void* wo,
                                         void* q8, void* k8, void* v8, void* qf, void* kf, void* vf,
                                         void* o8, void* out, int B, int L, int C, int groups,
                                         float inv_count, float scale, void* stream) {
  if ((C != 128 && C != 256) || groups > 32 || C % groups != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_quant3_kernel<<<B, GQ_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gn), static_cast<const float*>(sqkv),
      nq, nk, nv, static_cast<int8_t*>(q8), static_cast<int8_t*>(k8), static_cast<int8_t*>(v8), L, C,
      groups, inv_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float* e = static_cast<const float*>(eqkv);
  const void* xs[3] = {q8, k8, v8};
  const void* ws[3] = {wq, wk, wv};
  void* fs[3] = {qf, kf, vf};
  for (int i = 0; i < 3; ++i) {
    err = launch_igemm<1, EPI_F32>(proj_args(xs[i], ws[i], e + 2 * i * C, e + (2 * i + 1) * C, fs[i], B, L, C), s);
    if (err != cudaSuccess) return (int)err;
  }

  const float* so = static_cast<const float*>(sqo);
  err = (C == 128)
            ? launch_core<128>(static_cast<const float*>(qf), static_cast<const float*>(kf),
                               static_cast<const float*>(vf), so, n_o, static_cast<int8_t*>(o8), B, L, scale, s)
            : launch_core<256>(static_cast<const float*>(qf), static_cast<const float*>(kf),
                               static_cast<const float*>(vf), so, n_o, static_cast<int8_t*>(o8), B, L, scale, s);
  if (err != cudaSuccess) return (int)err;

  IgemmArgs a = proj_args(o8, wo, so + 2 * C, so + 3 * C, out, B, L, C);
  a.res = static_cast<const __nv_bfloat16*>(x);
  return (int)launch_igemm<1, EPI_RESADD_BF16>(a, s);
}
