// K3: the whole DDIM attention block with int8 projections.
//
// Replaces the TPU kernel attentiondm_tpu/ops/int8_attention.py
// fused_attention_block (_attn_block_kernel), one program per batch block
// with everything in VMEM.  One image's f32 logits (L*L*4 B = 256 KB at
// L = 256) exceed a Hopper block's shared memory, so here the block is a
// chain of four launches behind one C entry point, in the TPU kernel's
// order of operations:
//   1. the K4 pass (common.cuh gn_act_quant_kernel, no activation):
//      GroupNorm statistics and normalize of the bf16 residual, one block
//      per image, written as three int8 tensors at the q / k / v input
//      quant scales;
//   2. the q / k / v 1x1 projections: the int8 GEMM of K1 (igemm.cuh: wgmma
//      from a TMA-fed ring, weights K-major) with an f32 dequant epilogue;
//   3. attn_core: f32 logits (q k^T, then * C^-1/2), softmax (max, exp,
//      divide by the sum) and AV for a 16-query tile per block, logits in
//      shared memory, then the int8 quant of proj_out's input.  In the
//      `int8_core` mode (amax != nullptr) q and k are first re-quantized to
//      int8 at per-image dynamic scales (attn_common.cuh) and the logits are
//      float(q8 . k8) * (sq * sk * C^-1/2), the dot in integers (__dp4a);
//      softmax and AV stay f32 on the f32 v, as in the TPU kernel;
//   4. the output projection: the int8 GEMM with a dequant + residual-add
//      epilogue, written at the residual's dtype (bf16).
// The core runs in f32, as the TPU kernel's default core: the q.k dot, the
// softmax denominator and p.v accumulate in f32 (fmaf for the dot
// products).  Its plain version (torch f32 einsums, cuBLAS on the card)
// sums in another order, so the two agree to rounding, not to the bit; the
// GroupNorm sums in front follow the fixed order of common.cuh and agree
// exactly.
// What bounds it on the H100: the core runs on the CUDA cores (no TF32),
// 2*L*L*C f32 multiply-adds per image with their operands read from shared
// memory.  Fusing the chain (flash-style, tensor-core f32 emulation or a
// bf16 core with a quality check) is later work.
#include "attn_common.cuh"
#include "igemm.cuh"

using namespace adm;

constexpr int AT_THREADS = 256, AT_BQ = 16, AT_TK = 16;

// words per shared-memory row of a Q / K tile: f32 values, or int8 packed four
// to a word; one word of padding makes the column walks conflict-free
#define AT_LD(C, I8) (((I8) ? (C) / 4 : (C)) + 1)

template <int C, bool I8>
__global__ void __launch_bounds__(AT_THREADS)
attn_core_kernel(const float* __restrict__ qf, const float* __restrict__ kf,
                 const float* __restrict__ vf, const int8_t* __restrict__ q8,
                 const int8_t* __restrict__ k8, const unsigned* __restrict__ amax,
                 const float* __restrict__ sqo, int n_o, int8_t* __restrict__ o8, int L, float scale) {
  extern __shared__ float sm[];
  constexpr int LD = AT_LD(C, I8), W = LD - 1;  // W words of data a row
  float* Qs = sm;                // [BQ][LD]
  float* Ks = Qs + AT_BQ * LD;   // [TK][LD]
  float* S = Ks + AT_TK * LD;    // [BQ][L] logits, then probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * AT_BQ;
  const float* V = vf + (long long)b * L * C;
  // rows as words: the f32 q / k, or the int8 q8 / k8 four channels to a word
  const float* Q = I8 ? reinterpret_cast<const float*>(q8 + ((long long)b * L + q0) * C)
                      : qf + ((long long)b * L + q0) * C;
  const float* K = I8 ? reinterpret_cast<const float*>(k8 + (long long)b * L * C) : kf + (long long)b * L * C;
  float ls = scale;
  if (I8) ls = dyn_scale(amax[b * 2]) * dyn_scale(amax[b * 2 + 1]) * scale;

  for (int i = tid; i < AT_BQ * W; i += AT_THREADS) {
    const int r = i / W, cc = i - r * W;
    Qs[r * LD + cc] = (q0 + r < L) ? Q[i] : 0.f;
  }
  // logits: thread -> query qi, key kj of each TK-key tile
  const int qi = tid / AT_TK, kj = tid % AT_TK;
  for (int j0 = 0; j0 < L; j0 += AT_TK) {
    __syncthreads();
    for (int i = tid; i < AT_TK * W; i += AT_THREADS) {
      const int r = i / W, cc = i - r * W;
      Ks[r * LD + cc] = (j0 + r < L) ? K[(long long)(j0 + r) * W + cc] : 0.f;
    }
    __syncthreads();
    float lf;
    if (I8) {
      int d = 0;
#pragma unroll 8
      for (int cc = 0; cc < W; ++cc) d = __dp4a(__float_as_int(Qs[qi * LD + cc]), __float_as_int(Ks[kj * LD + cc]), d);
      lf = (float)d * ls;
    } else {
      float d = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < W; ++cc) d = fmaf(Qs[qi * LD + cc], Ks[kj * LD + cc], d);
      lf = d * ls;
    }
    if (j0 + kj < L) S[qi * L + j0 + kj] = lf;
  }
  __syncthreads();
  // softmax, one warp per row: e = exp(l - max), p = e / sum(e)
  for (int r = warp; r < AT_BQ; r += AT_THREADS / 32) {
    float* row = S + r * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    const float total = warp_sum(sum);
    for (int j = lane; j < L; j += 32) row[j] = row[j] / total;
  }
  __syncthreads();
  // AV: thread -> CPT channels c0 + i * CW and RPT consecutive query rows
  // (C = 512: 2 channels x 16 rows = 32 accumulators); then int8 quant
  constexpr int CPT = C > AT_THREADS ? C / AT_THREADS : 1, CW = C / CPT;
  constexpr int RPT = AT_BQ * CW / AT_THREADS;
  const int c0 = tid % CW, rb = (tid / CW) * RPT;
  float acc[CPT][RPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[i][r] = 0.f;
  for (int j = 0; j < L; ++j) {
    float vv[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) vv[i] = V[(long long)j * C + c0 + i * CW];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float p = S[(rb + r) * L + j];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[i][r] = fmaf(p, vv[i], acc[i][r]);
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int cc = c0 + i * CW;
    const float so = sqo[cc], zo = sqo[C + cc];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (q0 + rb + r < L) o8[((long long)b * L + q0 + rb + r) * C + cc] = quant_i8(acc[i][r], so, zo, n_o);
  }
}

template <int C, bool I8>
static cudaError_t launch_core_mode(const float* qf, const float* kf, const float* vf, const int8_t* q8,
                                    const int8_t* k8, const unsigned* amax, const float* sqo, int n_o,
                                    int8_t* o8, int B, int L, float scale, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)(AT_BQ + AT_TK) * AT_LD(C, I8) + (size_t)AT_BQ * L);
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel<C, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + AT_BQ - 1) / AT_BQ, B);
  attn_core_kernel<C, I8><<<grid, AT_THREADS, smem, s>>>(qf, kf, vf, q8, k8, amax, sqo, n_o, o8, L, scale);
  return cudaGetLastError();
}

// amax == nullptr: the f32 core.  Otherwise the int8 core: q8 / k8 (free
// once the projections have read them) take the re-quantized q and k.
template <int C>
static cudaError_t launch_core(const float* qf, const float* kf, const float* vf, int8_t* q8, int8_t* k8,
                               unsigned* amax, const float* sqo, int n_o, int8_t* o8, int B, int L,
                               float scale, cudaStream_t s) {
  if (!amax) return launch_core_mode<C, false>(qf, kf, vf, q8, k8, amax, sqo, n_o, o8, B, L, scale, s);
  cudaError_t err = launch_dyn_quant_qk<float>(qf, nullptr, nullptr, kf, nullptr, nullptr, amax, q8, k8, B, L, C, s);
  if (err != cudaSuccess) return err;
  return launch_core_mode<C, true>(qf, kf, vf, q8, k8, amax, sqo, n_o, o8, B, L, scale, s);
}

static IgemmArgs proj_args(const void* x8, const void* wt, const float* iw, const float* zc, void* out,
                           int B, int L, int C, int bm, int cols) {
  IgemmArgs a;
  a.x = static_cast<const int8_t*>(x8);
  a.wt = static_cast<const int8_t*>(wt);
  a.inv_ws = iw;
  a.zcbias = zc;
  a.res = nullptr;
  a.out = out;
  a.B = B; a.Hp = L; a.Wp = 1; a.Cp = C; a.Ho = L; a.Wo = 1; a.Np = C; a.stride = 1;
  a.tile = IgemmTile{bm, cols, 1, 1};  // the flat GEMM over B * L rows (ops/pallas_conv.conv_tiles)
  return a;
}

extern "C" int adm_fused_attention_block(const void* x, const void* gn, const void* sqkv, int nq, int nk,
                                         int nv, const void* wq, const void* wk, const void* wv,
                                         const void* eqkv, const void* sqo, int n_o, const void* wo,
                                         void* q8, void* k8, void* v8, void* qf, void* kf, void* vf,
                                         void* o8, void* amax, void* out, int B, int L, int C, int groups,
                                         float inv_count, float scale, int bm, int cols, void* stream) {
  if ((C != 128 && C != 256 && C != 512) || L > GN_CHUNK || groups > 32 || C % groups != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GnQuantArgs ga = {};
  ga.gn_scale = static_cast<const float*>(gn);
  ga.gn_bias = ga.gn_scale + C;
  void* q8s[3] = {q8, k8, v8};
  const int ns[3] = {nq, nk, nv};
  for (int i = 0; i < 3; ++i) {
    ga.scale[i] = static_cast<const float*>(sqkv) + 2 * i * C;
    ga.zp[i] = ga.scale[i] + C;
    ga.out[i] = static_cast<int8_t*>(q8s[i]);
    ga.n_levels[i] = ns[i];
  }
  ga.n_out = 3; ga.swish = 0; ga.HW = L; ga.N = C; ga.G = groups; ga.inv_count = inv_count; ga.halo_w = 0;
  cudaError_t err = launch_gn_act_quant(static_cast<const __nv_bfloat16*>(x), ga, B, s);
  if (err != cudaSuccess) return (int)err;

  const float* e = static_cast<const float*>(eqkv);
  const void* xs[3] = {q8, k8, v8};
  const void* ws[3] = {wq, wk, wv};
  void* fs[3] = {qf, kf, vf};
  for (int i = 0; i < 3; ++i) {
    err = launch_igemm<1, EPI_F32>(proj_args(xs[i], ws[i], e + 2 * i * C, e + (2 * i + 1) * C, fs[i], B, L, C, bm, cols), s);
    if (err != cudaSuccess) return (int)err;
  }

  const float* so = static_cast<const float*>(sqo);
  const float *qp = static_cast<const float*>(qf), *kp = static_cast<const float*>(kf),
              *vp = static_cast<const float*>(vf);
  int8_t *op = static_cast<int8_t*>(o8), *q8p = static_cast<int8_t*>(q8), *k8p = static_cast<int8_t*>(k8);
  unsigned* am = static_cast<unsigned*>(amax);  // [B, 2] zeroed: the int8 core; nullptr: the f32 core
  if (C == 128) err = launch_core<128>(qp, kp, vp, q8p, k8p, am, so, n_o, op, B, L, scale, s);
  else if (C == 256) err = launch_core<256>(qp, kp, vp, q8p, k8p, am, so, n_o, op, B, L, scale, s);
  else err = launch_core<512>(qp, kp, vp, q8p, k8p, am, so, n_o, op, B, L, scale, s);
  if (err != cudaSuccess) return (int)err;

  IgemmArgs a = proj_args(o8, wo, so + 2 * C, so + 3 * C, out, B, L, C, bm, cols);
  a.res = static_cast<const __nv_bfloat16*>(x);
  return (int)launch_igemm<1, EPI_RESADD_BF16>(a, s);
}
