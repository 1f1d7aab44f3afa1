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
//   3. attn_core (below): logits, softmax and p.v for a block of queries,
//      then the int8 quant of proj_out's input.  In the `int8_core` mode
//      (amax != nullptr) q and k are first re-quantized to int8 at
//      per-image dynamic scales (attn_common.cuh) and the logits are
//      float(q8 . k8) * (sq * sk * C^-1/2);
//   4. the output projection: the int8 GEMM with a dequant + residual-add
//      epilogue, written at the residual's dtype (bf16).
//
// The core, in the TPU kernel's order: logits (q k^T, then * ls), the row
// maximum over all L keys, e = exp(logits - max), p = e / sum(e) by a true
// division, av = p . v, quant_i8(av).  What bounds it on the H100: 4 L^2 C
// multiply-adds per image in f32, against 12 L C bytes; on the CUDA cores
// (67 TFLOP/s) that is its whole time.  The design:
//   - products on the tensor cores.  f32 mode: mma.sync m16n8k8 TF32 with
//     the 3-term split (attn_common.cuh mma_3xtf32), for q k^T and p v: f32
//     to about 2^-22 of each product, 495 / 3 TFLOP/s.  int8 mode: q8 k8^T
//     by mma.sync m16n8k32 s8, exact int32 (the logits of the __dp4a core it
//     replaces, bit for bit); p v by 3xTF32 as in f32 mode;
//   - a block of BQ = 64 queries (8 warps: 4 row groups of 16 queries, each
//     split in two over the keys for q k^T and over the channels for p v),
//     32 above L = 512.  The block's BQ x L f32 logits stay in shared memory
//     and the softmax runs there, row by row, as before;
//   - q and k stream through a cp.async ring in chunks of 128 bytes a row
//     (32 f32 or 128 int8 channels) for 64 keys, v in tiles of VK keys x CP
//     channels over the keys below L (a warp holds 64 channels of p v, 32
//     accumulators; wider C loops over channel passes, re-reading v from
//     L2).  Every copy is asynchronous and overlaps the products of the
//     tiles before it; one barrier a tile.  The ring has as many stages (2
//     to 4) as leave two blocks an SM: 2 at L = 256 (101 KB a block), 4 at
//     L <= 64, where a tile's few products cannot hide a load's latency.
// The launch geometry (BQ, VK, stages, shared bytes) is computed in Python
// (ops/int8_attention.core_plan, held by CPU tests) and passed in; the
// launcher checks it against its own (at_* below).  The softmax
// denominator and p.v sum in another order than the plain version (torch
// einsums), so the two agree to rounding, not to the bit; the GroupNorm
// sums in front follow the fixed order of common.cuh and agree exactly.
#include <type_traits>

#include "attn_common.cuh"
#include "igemm.cuh"

using namespace adm;

constexpr int AT_THREADS = 256, AT_WARPS = AT_THREADS / 32;
constexpr int AT_KT = 64;                // keys of a logits tile
constexpr int AT_ROWB = 128;             // bytes of a row in a q / k chunk: 32 f32 or 128 int8 channels
constexpr int AT_LDW = AT_ROWB / 4 + 4;  // its stride in 32-bit words (36): fragment reads hit 32 banks
constexpr int AT_PV_CH = 64;             // p.v channels a warp holds at most (32 accumulators)

// keys rounded up to whole tiles; queries a block; channels of one p.v pass; keys of a v tile
__host__ __device__ constexpr int at_lp(int L) { return (L + AT_KT - 1) / AT_KT * AT_KT; }
__host__ __device__ constexpr int at_bq(int L) { return at_lp(L) <= 512 ? 64 : 32; }
__host__ __device__ constexpr int at_cp(int C, int bq) {
  return C < AT_WARPS / (bq / 16) * AT_PV_CH ? C : AT_WARPS / (bq / 16) * AT_PV_CH;
}
__host__ __device__ constexpr int at_vk(int cp) { return cp <= 128 ? 32 : 16; }
__host__ __device__ constexpr int at_stage_bytes(int C, int bq) {
  return (bq + AT_KT) * AT_LDW * 4 > at_vk(at_cp(C, bq)) * (at_cp(C, bq) + 8) * 4
             ? (bq + AT_KT) * AT_LDW * 4
             : at_vk(at_cp(C, bq)) * (at_cp(C, bq) + 8) * 4;
}
// ring stages: as many (2 to 4) as leave room for two blocks an SM (AT_TWO_BLOCKS bytes each)
constexpr int AT_TWO_BLOCKS = 115712;
__host__ __device__ constexpr int at_logit_bytes(int L, int bq) { return bq * (at_lp(L) + 4) * 4; }
__host__ __device__ constexpr int at_stages(int L, int C, int bq) {
  return (AT_TWO_BLOCKS - at_logit_bytes(L, bq)) / at_stage_bytes(C, bq) >= 4   ? 4
         : (AT_TWO_BLOCKS - at_logit_bytes(L, bq)) / at_stage_bytes(C, bq) == 3 ? 3
                                                                              : 2;
}
// the logits [bq][L rounded + 4] and the ring
__host__ __device__ constexpr long long at_smem_bytes(int L, int C, int bq) {
  return (long long)at_logit_bytes(L, bq) + (long long)at_stages(L, C, bq) * at_stage_bytes(C, bq);
}

struct AttnCoreArgs {
  const float *qf, *kf, *vf;   // [B, L, C] f32 projections
  const int8_t *q8, *k8;       // int8 mode: the re-quantized q and k
  const unsigned* amax;        // int8 mode: [B, 2] absolute maxima (bits); nullptr: f32 mode
  const float* sqo;            // proj_out's input quant: scale [C], zero point [C]
  int n_o;
  int8_t* o8;                  // [B, L, C]
  float* logits;               // optional [B, L, L]: the logits as the softmax reads them
  int L, stages;
  float scale;
};

template <int C, bool I8, int BQ>
__global__ void __launch_bounds__(AT_THREADS) attn_core_kernel(AttnCoreArgs a) {
  constexpr int RG = BQ / 16, WK = AT_WARPS / RG;  // row groups of 16 queries; warps of a row group
  constexpr int NT = AT_KT / WK / 8;                // n-tiles of 8 keys a warp's logits hold
  constexpr int ESZ = I8 ? 1 : 4, NCHUNK = C * ESZ / AT_ROWB;
  constexpr int CP = at_cp(C, BQ), NCH = CP / WK, NPT = NCH / 8, VK = at_vk(CP), LDV = CP + 8;
  constexpr int STAGE_W = at_stage_bytes(C, BQ) / 4;
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, LP = at_lp(L), LDS = LP + 4;
  float* S = sm;                  // [BQ][LDS] logits, then probabilities
  float* ring = sm + BQ * LDS;    // a.stages stages: q / k chunks, then v tiles
  const int NS = a.stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rg = warp / WK, wk = warp % WK, row0 = rg * 16;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long img = (long long)b * L * C;
  const char* Qg = I8 ? reinterpret_cast<const char*>(a.q8 + img) : reinterpret_cast<const char*>(a.qf + img);
  const char* Kg = I8 ? reinterpret_cast<const char*>(a.k8 + img) : reinterpret_cast<const char*>(a.kf + img);
  float ls = a.scale;
  if (I8) ls = dyn_scale(a.amax[b * 2]) * dyn_scale(a.amax[b * 2 + 1]) * a.scale;

  // ---- logits: item i = (key tile i / NCHUNK, channel chunk i % NCHUNK); rows past L load as zeros
  const int n1 = LP / AT_KT * NCHUNK;
  auto issue_qk = [&](int i) {
    float* st = ring + (i % NS) * STAGE_W;
    const int kt = i / NCHUNK, ch = i - kt * NCHUNK;
    for (int p = tid; p < (BQ + AT_KT) * (AT_ROWB / 16); p += AT_THREADS) {
      const int r = p / (AT_ROWB / 16), c16 = p % (AT_ROWB / 16);
      const bool isq = r < BQ;
      const int row = isq ? q0 + r : kt * AT_KT + r - BQ;
      const bool ok = row < L;
      const char* src = (isq ? Qg : Kg) + (long long)(ok ? row : 0) * C * ESZ + ch * AT_ROWB + c16 * 16;
      cp_async_16(st + r * AT_LDW + c16 * 4, src, ok);
    }
  };
  using Acc = typename std::conditional<I8, int, float>::type;
  Acc acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n1) issue_qk(s);
    cp_async_commit();
  }
  for (int i = 0; i < n1; ++i) {
    cp_async_wait_n(NS - 2);
    __syncthreads();  // item i has landed for every thread; the stage item i - 1 used is free
    if (i + NS - 1 < n1) issue_qk(i + NS - 1);
    cp_async_commit();
    const uint32_t* st = reinterpret_cast<const uint32_t*>(ring + (i % NS) * STAGE_W);
    const uint32_t* qs = st + (row0 + g) * AT_LDW;
    const uint32_t* ks = st + (BQ + wk * (AT_KT / WK) + g) * AT_LDW;
#pragma unroll
    for (int s = 0; s < AT_ROWB / 32; ++s) {  // k32 steps (s8) or k8 steps (tf32): 8 words a row each
      const int c = s * 8 + t;
      const uint32_t af[4] = {qs[c], qs[8 * AT_LDW + c], qs[c + 4], qs[8 * AT_LDW + c + 4]};
      if constexpr (I8) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t bf[2] = {ks[j * 8 * AT_LDW + c], ks[j * 8 * AT_LDW + c + 4]};
          mma_s8(acc[j], af, bf);
        }
      } else {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(__uint_as_float(af[e]), ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(__uint_as_float(ks[j * 8 * AT_LDW + c]), bh0, bl0);
          tf32_split(__uint_as_float(ks[j * 8 * AT_LDW + c + 4]), bh1, bl1);
          mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    if ((i + 1) % NCHUNK == 0) {  // the key tile is complete: its logits into S
      const int k0 = i / NCHUNK * AT_KT + wk * (AT_KT / WK);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + g + 8 * h, key = k0 + j * 8 + 2 * t;
          const float l0 = (float)acc[j][2 * h] * ls, l1 = (float)acc[j][2 * h + 1] * ls;
          *reinterpret_cast<float2*>(S + r * LDS + key) = make_float2(l0, l1);
          if (a.logits && q0 + r < L) {
            float* lr = a.logits + ((long long)b * L + q0 + r) * L;
            if (key < L) lr[key] = l0;
            if (key + 1 < L) lr[key + 1] = l1;
          }
          acc[j][2 * h] = 0;
          acc[j][2 * h + 1] = 0;
        }
    }
  }
  __syncthreads();  // S complete; every stage free

  // ---- p.v: item i = (channel pass i / NV, v tile i % NV) over the tiles that hold keys below L (p is 0
  // past L); the first tiles load during the softmax
  const int NV = (L + VK - 1) / VK, n3 = C / CP * NV;
  auto issue_v = [&](int i) {
    float* st = ring + (i % NS) * STAGE_W;
    const int pc = i / NV, vt = i - pc * NV;
    for (int p = tid; p < VK * (CP / 4); p += AT_THREADS) {
      const int r = p / (CP / 4), c4 = p % (CP / 4), key = vt * VK + r;
      const bool ok = key < L;
      cp_async_16(st + r * LDV + c4 * 4, a.vf + img + (long long)(ok ? key : 0) * C + pc * CP + c4 * 4, ok);
    }
  };
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n3) issue_v(s);
    cp_async_commit();
  }

  // softmax, one warp per row: e = exp(l - max), p = e / sum(e); keys past L get p = 0
  for (int r = warp; r < BQ; r += AT_WARPS) {
    float* row = S + r * LDS;
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
    for (int j = lane; j < LP; j += 32) row[j] = j < L ? row[j] / total : 0.f;
  }

  float o[NPT][4];
#pragma unroll
  for (int j = 0; j < NPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int i = 0; i < n3; ++i) {
    cp_async_wait_n(NS - 2);
    __syncthreads();  // also orders the softmax's writes before the first reads of p
    if (i + NS - 1 < n3) issue_v(i + NS - 1);
    cp_async_commit();
    const int pc = i / NV, vt = i - pc * NV;
    const float* vs = ring + (i % NS) * STAGE_W + wk * NCH + g;
    const float* pr = S + (row0 + g) * LDS + vt * VK + t;
#pragma unroll
    for (int s = 0; s < VK / 8; ++s) {
      uint32_t ah[4], al[4];
      tf32_split(pr[s * 8], ah[0], al[0]);
      tf32_split(pr[s * 8 + 8 * LDS], ah[1], al[1]);
      tf32_split(pr[s * 8 + 4], ah[2], al[2]);
      tf32_split(pr[s * 8 + 8 * LDS + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(vs[(s * 8 + t) * LDV + j * 8], bh0, bl0);
        tf32_split(vs[(s * 8 + t + 4) * LDV + j * 8], bh1, bl1);
        mma_3xtf32(o[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    if (vt == NV - 1) {  // the pass is complete: quantize its channels
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int cc = pc * CP + wk * NCH + j * 8 + 2 * t;
        const float s0 = a.sqo[cc], s1 = a.sqo[cc + 1], z0 = a.sqo[C + cc], z1 = a.sqo[C + cc + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + row0 + g + 8 * h;
          if (q < L) {
            char2 v;
            v.x = quant_i8(o[j][2 * h], s0, z0, a.n_o);
            v.y = quant_i8(o[j][2 * h + 1], s1, z1, a.n_o);
            *reinterpret_cast<char2*>(a.o8 + ((long long)b * L + q) * C + cc) = v;
          }
          o[j][2 * h] = 0.f;
          o[j][2 * h + 1] = 0.f;
        }
      }
    }
  }
}

template <int C, bool I8, int BQ>
static cudaError_t launch_core_mode(AttnCoreArgs a, int B, cudaStream_t s) {
  const int smem = (int)at_smem_bytes(a.L, C, BQ);
  a.stages = at_stages(a.L, C, BQ);
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel<C, I8, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  attn_core_kernel<C, I8, BQ><<<dim3((a.L + BQ - 1) / BQ, B), AT_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int C, bool I8>
static cudaError_t launch_core_bq(const AttnCoreArgs& a, int B, int bq, cudaStream_t s) {
  return bq == 64 ? launch_core_mode<C, I8, 64>(a, B, s) : launch_core_mode<C, I8, 32>(a, B, s);
}

// (bq, vk, smem) is the Python plan (ops/int8_attention.core_plan); a plan that differs from this file's
// is refused before anything launches
static bool core_plan_ok(int L, int C, int bq, int vk, int smem) {
  return (C == 128 || C == 256 || C == 512) && L >= 1 && L <= GN_CHUNK && bq == at_bq(L) &&
         vk == at_vk(at_cp(C, bq)) && smem == at_smem_bytes(L, C, bq);
}

// The core after the projections.  a.amax == nullptr: the f32 core.  Otherwise the int8 core: q8 / k8
// (free once the projections have read them) take the re-quantized q and k.
static cudaError_t launch_core(AttnCoreArgs a, int8_t* q8, int8_t* k8, int B, int C, int bq, cudaStream_t s) {
  if (a.amax) {
    cudaError_t err = launch_dyn_quant_qk<float>(a.qf, nullptr, nullptr, a.kf, nullptr, nullptr,
                                                 const_cast<unsigned*>(a.amax), q8, k8, B, a.L, C, s);
    if (err != cudaSuccess) return err;
    a.q8 = q8;
    a.k8 = k8;
    if (C == 128) return launch_core_bq<128, true>(a, B, bq, s);
    if (C == 256) return launch_core_bq<256, true>(a, B, bq, s);
    return launch_core_bq<512, true>(a, B, bq, s);
  }
  if (C == 128) return launch_core_bq<128, false>(a, B, bq, s);
  if (C == 256) return launch_core_bq<256, false>(a, B, bq, s);
  return launch_core_bq<512, false>(a, B, bq, s);
}

static AttnCoreArgs core_args(const void* qf, const void* kf, const void* vf, const void* amax, const void* sqo,
                              int n_o, void* o8, void* logits, int L, float scale) {
  AttnCoreArgs a;
  a.qf = static_cast<const float*>(qf);
  a.kf = static_cast<const float*>(kf);
  a.vf = static_cast<const float*>(vf);
  a.q8 = a.k8 = nullptr;
  a.amax = static_cast<const unsigned*>(amax);
  a.sqo = static_cast<const float*>(sqo);
  a.n_o = n_o;
  a.o8 = static_cast<int8_t*>(o8);
  a.logits = static_cast<float*>(logits);
  a.L = L;
  a.scale = scale;
  return a;
}

// The core alone, on f32 q, k, v [B, L, C]: sqo (proj_out's input scale [C], zero point [C]), o8 out;
// amax [B, 2] zeroed with scratch q8 / k8 for the int8 core, nullptr for the f32 core; logits [B, L, L]
// or nullptr
extern "C" int adm_attention_core(const void* qf, const void* kf, const void* vf, void* q8, void* k8, void* amax,
                                  const void* sqo, int n_o, void* o8, void* logits, int B, int L, int C, int bq,
                                  int vk, int smem, float scale, void* stream) {
  if (!core_plan_ok(L, C, bq, vk, smem)) return (int)cudaErrorInvalidValue;
  return (int)launch_core(core_args(qf, kf, vf, amax, sqo, n_o, o8, logits, L, scale), static_cast<int8_t*>(q8),
                          static_cast<int8_t*>(k8), B, C, bq, static_cast<cudaStream_t>(stream));
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
                                         float inv_count, float scale, int bm, int cols, int bq, int vk,
                                         int smem, void* stream) {
  if (!core_plan_ok(L, C, bq, vk, smem) || groups > 32 || C % groups != 0) return (int)cudaErrorInvalidValue;
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

  // amax [B, 2] zeroed: the int8 core; nullptr: the f32 core
  err = launch_core(core_args(qf, kf, vf, amax, sqo, n_o, o8, nullptr, L, scale), static_cast<int8_t*>(q8),
                    static_cast<int8_t*>(k8), B, C, bq, s);
  if (err != cudaSuccess) return (int)err;

  const float* so = static_cast<const float*>(sqo);
  IgemmArgs a = proj_args(o8, wo, so + 2 * C, so + 3 * C, out, B, L, C, bm, cols);
  a.res = static_cast<const __nv_bfloat16*>(x);
  return (int)launch_igemm<1, EPI_RESADD_BF16>(a, s);
}
