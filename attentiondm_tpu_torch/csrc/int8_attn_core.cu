// K8, K9 and K10: the int8 attention cores of the composed attention branch.
//
// Replace the TPU kernels of attentiondm_tpu/ops/int8_attention.py:
//   K8  fused_int8_attention (_attn_kernel): int32 q/k/v accumulators in,
//       dequantized, q and k re-quantized to int8 at per-image dynamic scales;
//   K9  fused_int8_attention_static (_static_attn_kernel): int8 q/k/v in,
//       calibrated scalar scales (sq, sk, sv);
//   K10 int8_flash_attention_static (_static_flash_kernel): K9's function
//       with an online softmax over key blocks of `bk` keys.
// All three: logits = int8 q . int8 k on the tensor cores (exact in int32),
// lf = float(logits) * (sq * sk * scale), f32 softmax, p cast to bf16,
// bf16 p . bf16 v with f32 accumulation, then the int8 quantization of
// proj_out's input, clip(round(out_scale * out - out_zp), -n, n - 1).
//
// The order of roundings is each TPU kernel's own, because the bf16 cast of
// p is a discontinuity:
//   K8 / K9 (NORM): the row maximum over all keys, e = exp(lf - m), p = e
//       divided by the row sum, then the cast; K9 multiplies by sv after PV.
//       Three sweeps over the keys (maximum, sum, PV), each recomputing the
//       integer logits, which is exact; keeping a row's L f32 logits instead
//       (8 KB a query at L = 2048) would not fit.
//   K10 (online): per block of bk keys, m_new = max(m, block maximum),
//       alpha = exp(m - m_new), un-normalised p = exp(lf - m_new) cast to
//       bf16, denom = denom * alpha + sum(p), acc = acc * alpha + p . v, and
//       acc / denom * sv at the end; m starts at -1e30.  Two sweeps a block
//       (maximum, then PV).
// The row maximum is taken over the integers: float(x) * ls is monotone in x
// for ls >= 0 (the scales are absmax / 127 > 0), so max(lf) is
// float(max(logits)) * ls to the bit.  expf is the full-precision one.
//
// What bounds it on the H100: operations (2 L^2 C int8 and 2 L^2 C bf16 per
// image on the tensor cores; the softmax's int -> float, exp, sum, bf16 cast
// and, for K8 / K9, a division per logit on the CUDA cores, two or three
// sweeps) against 4 L C bytes.  With warp-level mma.sync every warp of 16
// queries reads each K and V tile from shared memory for itself: at C = 128
// that is 192 KB of shared-memory reads per 64-key tile of a 128-query block,
// more than the tensor and CUDA-core work takes.  The design:
//   - warpgroup products (wgmma.mma_async).  A row group of 64 queries has
//     C / 128 warpgroups: they split the 64 keys of a tile for the logits
//     (s8 m64nNk32, N = 64 / (C / 128), Q and K from shared memory; each
//     logit is computed once a sweep, whatever C is) and the channels for p.v
//     (bf16 m64n128k16, 128 channels and 64 f32 accumulators a thread each).
//     p goes from the s8 product's accumulators to the bf16 product's A
//     operand in registers: the two layouts agree.  Where a row group has
//     more than one warpgroup, each writes its bf16 p fragments over the
//     tile's K (read by then) and reads its partners' after a barrier; row
//     maxima and sums meet in a small exchange.  A block is 128 queries (2
//     row groups) at C = 128 and 256, 64 at 512 (256, 512 and 512 threads);
//   - K and V stream through a ring of 3 stages (2 at C = 512) filled by
//     cp.async, 16 bytes a thread, into the 128-byte-swizzled layout the
//     wgmma descriptors read (igemm.cuh wgmma_desc, K1's); one barrier a
//     tile, so each tile's loads overlap the products of the tiles before it;
//   - V goes in as V^T [B, C, L] bf16, K-major for the p.v product: the
//     pre-pass that makes it bf16 (K8's dequant; the static cores' int8 V,
//     exact in bf16) writes it transposed through a shared-memory tile;
//   - Q is loaded once and read by every logits product from shared memory.
// The launch geometry (queries a block, stages, shared bytes) is computed in
// Python (ops/int8_attention.int8_core_plan) and checked here (ia_* below).
#include <limits.h>

#include "attn_common.cuh"
#include "igemm.cuh"

using namespace adm;

constexpr int IA_TK = 64;  // keys of a tile
constexpr float IA_NEG_INF = -1e30f;

// queries a block (row groups of 64), threads (a warpgroup per row group and 128 channels), ring stages
__host__ __device__ constexpr int ia_bq(int C) { return C == 512 ? 64 : 128; }
__host__ __device__ constexpr int ia_threads(int C) { return ia_bq(C) / 64 * (C / 128) * 128; }
__host__ __device__ constexpr int ia_stages(int C) { return C == 512 ? 2 : 3; }
// shared bytes: 1024 to align the swizzled tiles; Q [bq][C]; per stage K [64][C] and V^T [C][64 bf16]; the
// row groups' exchange of maxima and sums (C > 128)
__host__ __device__ constexpr int ia_smem_bytes(int C) {
  return 1024 + ia_bq(C) * C + ia_stages(C) * IA_TK * 3 * C + (C > 128 ? 2 * ia_bq(C) * (C / 128) * 4 : 0);
}

struct CoreArgs {
  const int8_t* q8;  // [B, L, C]
  const int8_t* k8;
  const __nv_bfloat16* vt;  // [B, C, L]: v transposed, in bf16
  const float* sc;          // static: (sq, sk, sv); nullptr when dynamic
  const unsigned* amax;     // dynamic: [B, 2] absolute maxima of q and k (bits)
  const float* out_scale;   // [C]
  const float* out_zp;      // [C]
  int8_t* out;              // [B, L, C]
  int L, bk, n_out;
  float scale;
};

#define IA_R4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define IA_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x N s32) = (acc ? d : 0) + A (64 x 32 s8, shared) . B (N x 32 s8, shared)^T
static __device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : IA_R4(d, 0), IA_R4(d, 4), IA_R4(d, 8), IA_R4(d, 12), IA_R4(d, 16), IA_R4(d, 20), IA_R4(d, 24), IA_R4(d, 28)
      : "l"(da), "l"(db), "r"(acc));
}

static __device__ __forceinline__ void wgmma_s8_n32(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : IA_R4(d, 0), IA_R4(d, 4), IA_R4(d, 8), IA_R4(d, 12)
      : "l"(da), "l"(db), "r"(acc));
}

static __device__ __forceinline__ void wgmma_s8_n16(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : IA_R4(d, 0), IA_R4(d, 4)
      : "l"(da), "l"(db), "r"(acc));
}

static __device__ __forceinline__ void wgmma_bf16_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : IA_F4(d, 0), IA_F4(d, 4), IA_F4(d, 8), IA_F4(d, 12), IA_F4(d, 16), IA_F4(d, 20), IA_F4(d, 24), IA_F4(d, 28), IA_F4(d, 32), IA_F4(d, 36), IA_F4(d, 40), IA_F4(d, 44), IA_F4(d, 48), IA_F4(d, 52), IA_F4(d, 56), IA_F4(d, 60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) . B (128 x 16 bf16, shared)^T, above

template <int NJ>
static __device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (NJ == 8) wgmma_s8_n64(d, da, db, acc);
  if constexpr (NJ == 4) wgmma_s8_n32(d, da, db, acc);
  if constexpr (NJ == 2) wgmma_s8_n16(d, da, db, acc);
}

static __device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// orders this thread's landed cp.async writes before the async proxy (wgmma) reads them
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled tile of 128-byte rows
static __device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

static __device__ __forceinline__ int quad_max(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

static __device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int C, bool NORM>
__global__ void __launch_bounds__(ia_threads(C)) int8_attn_core_kernel(CoreArgs a) {
  constexpr int WC = C / 128, BQ = ia_bq(C), THREADS = ia_threads(C), STAGES = ia_stages(C);
  constexpr int KW = IA_TK / WC, NJ = KW / 8;  // keys of a warpgroup's logits; their n-tiles of 8
  constexpr int K_BYTES = IA_TK * C, STAGE = K_BYTES + C * 128;
  extern __shared__ unsigned char ia_raw[];
  // the swizzle is a function of the address: the tiles start on 1024 bytes
  const uint32_t raw = sh_addr(ia_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* Qs = ia_raw + (base - raw);  // C / 128 slabs of [BQ][128 bytes]
  unsigned char* ring = Qs + BQ * C;          // STAGES x {K: C / 128 slabs of [64][128]; V^T: [C][128]}
  int* red_i = reinterpret_cast<int*>(ring + STAGES * STAGE);  // [BQ / 64][WC][64] (WC > 1)
  float* red_f = reinterpret_cast<float*>(red_i + BQ * WC);    // [BQ / 64][WC][64] (WC > 1)
  const uint32_t qs_a = base, ring_a = base + BQ * C;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3, rg = wg / WC, wc = wg % WC;
  const int row = wq * 16 + g;  // this thread's rows of its row group: row and row + 8
  const int b = blockIdx.y, q0 = blockIdx.x * BQ, L = a.L;
  const long long img = (long long)b * L * C;

  float sq, sk, sv = 1.f;
  if (a.sc) {
    sq = a.sc[0];
    sk = a.sc[1];
    sv = a.sc[2];
  } else {
    sq = dyn_scale(a.amax[b * 2]);
    sk = dyn_scale(a.amax[b * 2 + 1]);
  }
  const float ls = sq * sk * a.scale;

  for (int p = tid; p < BQ * (C / 16); p += THREADS) {  // Q, rows past L as zeros
    const int r = p / (C / 16), c16 = p % (C / 16);
    const bool ok = q0 + r < L;
    cp_async_16(Qs + (c16 >> 3) * BQ * 128 + swz(r, c16 & 7),
                a.q8 + img + (long long)(ok ? q0 + r : 0) * C + c16 * 16, ok);
  }
  cp_async_commit();

  // the ring's items: key block kb, sweep sw (the last one with V), 64-key tile sub
  const int nsub = a.bk / IA_TK, nsw = NORM ? 3 : 2, per_block = nsw * nsub, n_items = L / a.bk * per_block;
  auto issue = [&](int i) {
    const int kb = i / per_block, rem = i - kb * per_block, sw = rem / nsub, sub = rem - sw * nsub;
    const int k0 = kb * a.bk + sub * IA_TK;
    unsigned char* st = ring + (i % STAGES) * STAGE;
    for (int p = tid; p < IA_TK * (C / 16); p += THREADS) {
      const int r = p / (C / 16), c16 = p % (C / 16);
      cp_async_16(st + (c16 >> 3) * IA_TK * 128 + swz(r, c16 & 7), a.k8 + img + (long long)(k0 + r) * C + c16 * 16,
                  true);
    }
    if (sw == nsw - 1)
      for (int p = tid; p < C * 8; p += THREADS) {  // channel p / 8, keys k0 + 8 (p % 8) .. + 7
        const int r = p >> 3, c = p & 7;
        cp_async_16(st + K_BYTES + swz(r, c), a.vt + img + (long long)r * L + k0 + c * 8, true);
      }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_items) issue(s);
    cp_async_commit();
  }

  // the row group's warpgroups combine a per-row value (rows row and row + 8): maximum over ints, sum over floats
  const int red0 = rg * WC * 64 + row;
  auto group_max = [&](int& v0, int& v1) {
    if (WC == 1) return;
    if (t == 0) {
      red_i[red0 + wc * 64] = v0;
      red_i[red0 + wc * 64 + 8] = v1;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WC; ++w) {
      v0 = max(v0, red_i[red0 + w * 64]);
      v1 = max(v1, red_i[red0 + w * 64 + 8]);
    }
  };
  auto group_sum = [&](float& v0, float& v1) {
    if (WC == 1) return;
    if (t == 0) {
      red_f[red0 + wc * 64] = v0;
      red_f[red0 + wc * 64 + 8] = v1;
    }
    __syncthreads();
    v0 = v1 = 0.f;
#pragma unroll
    for (int w = 0; w < WC; ++w) {
      v0 += red_f[red0 + w * 64];
      v1 += red_f[red0 + w * 64 + 8];
    }
  };

  // s[4 j + e]: logits of keys wc * KW + 8 j + 2 t (+ 1 for odd e) of the tile, rows row (e < 2) and row + 8
  int s[NJ * 4];
  float o[64];  // [4 j + e]: channels wc * 128 + 8 j + 2 t (+ 1), rows as s
#pragma unroll
  for (int e = 0; e < NJ * 4; ++e) s[e] = 0;
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] = 0.f;
  float m0 = IA_NEG_INF, m1 = IA_NEG_INF, den0 = 0.f, den1 = 0.f, tot0 = 0.f, tot1 = 0.f;
  int i0 = INT_MIN, i1 = INT_MIN;

  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // item i has landed for every thread; the stage item i - 1 used is free
    if (i + STAGES - 1 < n_items) issue(i + STAGES - 1);
    cp_async_commit();
    const int rem = i % per_block, sw = rem / nsub, sub = rem - sw * nsub;
    const uint32_t st_a = ring_a + (i % STAGES) * STAGE;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 32; ++kk)
      wgmma_s8<NJ>(s, wgmma_desc(qs_a + (kk >> 2) * BQ * 128 + rg * 64 * 128) + 2 * (kk & 3),
                   wgmma_desc(st_a + (kk >> 2) * IA_TK * 128 + wc * KW * 128) + 2 * (kk & 3), kk > 0);
    wgmma_commit();
    wgmma_wait_all();

    if (sw == 0) {  // the block's row maxima, over the integer logits
      if (sub == 0) i0 = i1 = INT_MIN;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        i0 = max(i0, max(s[4 * j], s[4 * j + 1]));
        i1 = max(i1, max(s[4 * j + 2], s[4 * j + 3]));
      }
      if (sub == nsub - 1) {
        int im0 = quad_max(i0), im1 = quad_max(i1);
        group_max(im0, im1);
        const float mn0 = fmaxf(m0, (float)im0 * ls), mn1 = fmaxf(m1, (float)im1 * ls);
        if (!NORM) {
          const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
          den0 = den0 * al0;
          den1 = den1 * al1;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            o[4 * j] *= al0;
            o[4 * j + 1] *= al0;
            o[4 * j + 2] *= al1;
            o[4 * j + 3] *= al1;
          }
        }
        m0 = mn0;
        m1 = mn1;
      }
      continue;
    }
    if (NORM && sw == 1) {  // the row sums of e = exp(lf - m)
      if (sub == 0) tot0 = tot1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        tot0 += expf((float)s[4 * j] * ls - m0);
        tot0 += expf((float)s[4 * j + 1] * ls - m0);
        tot1 += expf((float)s[4 * j + 2] * ls - m1);
        tot1 += expf((float)s[4 * j + 3] * ls - m1);
      }
      if (sub == nsub - 1) {
        tot0 = quad_sum(tot0);
        tot1 = quad_sum(tot1);
        group_sum(tot0, tot1);
      }
      continue;
    }
    // the last sweep: p, cast to bf16, and p . v
    uint32_t pb[NJ][2];  // bf16 pairs: rows row and row + 8 of keys 8 j + 2t, + 1
    float z0 = 0.f, z1 = 0.f;  // K10: the tile's share of the denominator
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float p0 = expf((float)s[4 * j] * ls - m0), p1 = expf((float)s[4 * j + 1] * ls - m0);
      float p2 = expf((float)s[4 * j + 2] * ls - m1), p3 = expf((float)s[4 * j + 3] * ls - m1);
      if (NORM) {
        p0 = p0 / tot0;
        p1 = p1 / tot0;
        p2 = p2 / tot1;
        p3 = p3 / tot1;
      } else {
        z0 += p0 + p1;
        z1 += p2 + p3;
      }
      pb[j][0] = pack_bf16(p0, p1);
      pb[j][1] = pack_bf16(p2, p3);
    }
    uint32_t pa[IA_TK / 16][4];  // the p.v A operand, keys 16 ks .. + 15
    if constexpr (WC == 1) {
#pragma unroll
      for (int ks = 0; ks < IA_TK / 16; ++ks) {
        pa[ks][0] = pb[2 * ks][0];
        pa[ks][1] = pb[2 * ks][1];
        pa[ks][2] = pb[2 * ks + 1][0];
        pa[ks][3] = pb[2 * ks + 1][1];
      }
    } else {  // hand the fragments to the row group over the tile's K, which every logits product has read
      // [BQ / 64][WC][4 warps][NJ][2][32 lanes]: 8 KB a row group, within the K tile's 64 C bytes
      uint32_t* X = reinterpret_cast<uint32_t*>(ring + (i % STAGES) * STAGE) + rg * WC * 4 * NJ * 2 * 32;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        X[((wc * 4 + wq) * NJ * 2 + 2 * j) * 32 + lane] = pb[j][0];
        X[((wc * 4 + wq) * NJ * 2 + 2 * j + 1) * 32 + lane] = pb[j][1];
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < IA_TK / 16; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int J = 2 * ks + h, w = J / NJ, j = J % NJ;  // the n-tile of 8 keys, its warpgroup
          pa[ks][2 * h] = X[((w * 4 + wq) * NJ * 2 + 2 * j) * 32 + lane];
          pa[ks][2 * h + 1] = X[((w * 4 + wq) * NJ * 2 + 2 * j + 1) * 32 + lane];
        }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < IA_TK / 16; ++ks)
      wgmma_bf16_n128(o, pa[ks], wgmma_desc(st_a + K_BYTES + wc * 128 * 128) + 2 * ks);
    wgmma_commit();
    wgmma_wait_all();
    if (!NORM) {
      den0 += quad_sum(z0);
      den1 += quad_sum(z1);
    }
  }
  if (!NORM) group_sum(den0, den1);  // each warpgroup summed p over its own keys

#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = wc * 128 + 8 * j + 2 * t;
    const float s0 = a.out_scale[c], s1 = a.out_scale[c + 1], zp0 = a.out_zp[c], zp1 = a.out_zp[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + rg * 64 + row + 8 * h;
      float o0 = o[4 * j + 2 * h], o1 = o[4 * j + 2 * h + 1];
      if (NORM) {
        o0 = o0 * sv;
        o1 = o1 * sv;
      } else {
        const float den = h ? den1 : den0;
        o0 = o0 / den * sv;
        o1 = o1 / den * sv;
      }
      if (q < L) {
        char2 v;
        v.x = quant_i8(o0, s0, zp0, a.n_out);
        v.y = quant_i8(o1, s1, zp1, a.n_out);
        *reinterpret_cast<char2*>(a.out + img + (long long)q * C + c) = v;
      }
    }
  }
}

template <int C, bool NORM>
static cudaError_t launch_core_c(const CoreArgs& a, int B, cudaStream_t s) {
  const int smem = ia_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(int8_attn_core_kernel<C, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int8_attn_core_kernel<C, NORM><<<dim3((a.L + ia_bq(C) - 1) / ia_bq(C), B), ia_threads(C), smem, s>>>(a);
  return cudaGetLastError();
}

// (bq, stages, smem) is the Python plan (ops/int8_attention.int8_core_plan); a plan that differs from this
// file's is refused before anything launches
static bool plan_ok(int L, int C, int bk, int bq, int stages, int smem) {
  return (C == 128 || C == 256 || C == 512) && L > 0 && L % IA_TK == 0 && bk > 0 && bk % IA_TK == 0 &&
         L % bk == 0 && bq == ia_bq(C) && stages == ia_stages(C) && smem == ia_smem_bytes(C);
}

template <bool NORM>
static cudaError_t launch_core(const CoreArgs& a, int B, int C, cudaStream_t s) {
  if (C == 128) return launch_core_c<128, NORM>(a, B, s);
  if (C == 256) return launch_core_c<256, NORM>(a, B, s);
  return launch_core_c<512, NORM>(a, B, s);
}

// vt [B, C, L] = bf16(dot * inv_ws + zcbias) transposed, the p.v operand of the dynamic core, or (inv_ws ==
// nullptr) bf16(v) of the static cores' int8 v, exact; x [B, L, C], 32 x 32 tiles through shared memory
template <typename T>
__global__ void __launch_bounds__(256)
to_bf16_t_kernel(const T* __restrict__ x, const float* __restrict__ inv_ws, const float* __restrict__ zcbias,
                 __nv_bfloat16* __restrict__ out, int L, int C) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, l0 = blockIdx.y * 32, c0 = blockIdx.x * 32, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    tile[r][tx] = proj_value(x, ((long long)b * L + l0 + r) * C + c0 + tx, inv_ws, zcbias, c0 + tx);
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    out[((long long)b * C + c0 + r) * L + l0 + tx] = __float2bfloat16_rn(tile[tx][r]);
}

template <typename T>
static cudaError_t launch_to_bf16_t(const T* x, const float* inv_ws, const float* zcbias, __nv_bfloat16* out,
                                    int B, int L, int C, cudaStream_t s) {
  to_bf16_t_kernel<T><<<dim3(C / 32, L / 32, B), 256, 0, s>>>(x, inv_ws, zcbias, out, L, C);
  return cudaGetLastError();
}

// K9 (bk == L) and K10 (bk < L): int8 q, k, v and the scalars (sq, sk, sv); scratch vt bf16 [B, C, L];
// (bq, stages, smem) the plan
extern "C" int adm_int8_attention_static(const void* q8, const void* k8, const void* v8, const void* sc,
                                         const void* out_scale, const void* out_zp, int n_out, void* vt, void* out,
                                         int B, int L, int C, int bk, int online, float scale, int bq, int stages,
                                         int smem, void* stream) {
  if (!plan_ok(L, C, bk, bq, stages, smem) || (!online && bk != L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* v = static_cast<__nv_bfloat16*>(vt);
  cudaError_t err = launch_to_bf16_t(static_cast<const int8_t*>(v8), nullptr, nullptr, v, B, L, C, s);
  if (err != cudaSuccess) return (int)err;
  CoreArgs a = {static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v, static_cast<const float*>(sc),
                nullptr, static_cast<const float*>(out_scale), static_cast<const float*>(out_zp),
                static_cast<int8_t*>(out), L, bk, n_out, scale};
  return (int)(online ? launch_core<false>(a, B, C, s) : launch_core<true>(a, B, C, s));
}

// K8: int32 q / k / v accumulators with their (inv_ws, zcbias); scratch amax
// [B, 2] (zeroed), q8 / k8 int8 [B, L, C] and vt bf16 [B, C, L]; (bq, stages, smem) the plan
extern "C" int adm_fused_int8_attention(const void* dq, const void* dk, const void* dv, const void* iw_q,
                                        const void* zc_q, const void* iw_k, const void* zc_k, const void* iw_v,
                                        const void* zc_v, const void* out_scale, const void* out_zp, int n_out,
                                        void* amax, void* q8, void* k8, void* vt, void* out, int B, int L, int C,
                                        float scale, int bq, int stages, int smem, void* stream) {
  if (!plan_ok(L, C, L, bq, stages, smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = launch_dyn_quant_qk(static_cast<const int32_t*>(dq), f(iw_q), f(zc_q),
                                        static_cast<const int32_t*>(dk), f(iw_k), f(zc_k),
                                        static_cast<unsigned*>(amax), static_cast<int8_t*>(q8),
                                        static_cast<int8_t*>(k8), B, L, C, s);
  if (err != cudaSuccess) return (int)err;
  __nv_bfloat16* v = static_cast<__nv_bfloat16*>(vt);
  err = launch_to_bf16_t(static_cast<const int32_t*>(dv), f(iw_v), f(zc_v), v, B, L, C, s);
  if (err != cudaSuccess) return (int)err;
  CoreArgs a = {static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v, nullptr,
                static_cast<const unsigned*>(amax), f(out_scale), f(out_zp), static_cast<int8_t*>(out), L, L, n_out,
                scale};
  return (int)launch_core<true>(a, B, C, s);
}
