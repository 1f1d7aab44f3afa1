// K11: f32 flash attention, softmax(q * scale . k^T) . v with an online
// softmax, for the long maps of the FP UNet (L >= 1024).
//
// Replaces the TPU kernel attentiondm_tpu/ops/attention.py flash_attention
// (_flash_kernel): one program per (image, 256-query block) with all of K and
// V in VMEM, streaming key blocks of 512.  In its order: q is scaled before
// the dot; per key block, m_new = max(m, row maximum of the block), p =
// exp(s - m_new), alpha = exp(m - m_new), denom = denom * alpha + sum(p),
// acc = acc * alpha + p . v, and acc / denom at the end; m starts at -1e30.
// Everything is f32.
//
// What bounds it on the H100: operations, 4 L^2 D f32 per image on the CUDA
// cores (fmaf; the tensor cores have no f32 mode) against 16 L D bytes.  Every
// FMA's operands come from shared memory, so the design is about FMAs per
// shared-memory read and about never waiting for a load:
//   - a block of 256 threads owns BQ queries of one image.  In q . k^T thread
//     (ty, txq, g) owns queries ty + TY i (RQ of them) and keys txq + 16 j of a
//     tile (RK = 4), float4 steps along the channels; in p . v it owns the same
//     queries and channels 4 (tx + TX j) .. + 3.  The accumulator (BQ x D f32,
//     64 registers a thread) stays in registers.  D = 128: BQ = 128, RQ = 8
//     (12 shared-memory float4 reads per 128 FMAs) where 128-query blocks fill
//     the 132 SMs, else BQ = 64, RQ = 4.  D = 256: BQ = 64 too (the former
//     kernel fell to 32), with RQ = 8: lane pairs (g = 0, 1) split the channel
//     chunks of q . k^T and add their partial dots by one shuffle, and p . v
//     runs 8 queries x 8 channels a thread;
//   - the logits of one inner key block (BQ x IB) live in shared memory,
//     because a block's row maximum has to be known before any of its p.  IB
//     is what fits beside Q and two tiles (128 keys at D = 128, 64 at D =
//     256).  Where the caller's block_k is larger, the online update runs once
//     per inner block: the same recurrence over finer blocks, so the last
//     bits move, inside the tolerance (measured on the H100: 512 logits a row
//     with 32-key tiles, 24.5 ms at (64, 4096, 128), against 15.4 ms so);
//   - K and then V stream through two tiles of 64 keys filled by cp.async (16
//     bytes a thread): tile t + 1 loads while tile t is multiplied, with one
//     __syncthreads() a tile;
//   - the softmax is spread over the whole block: each thread keeps the
//     running maximum of the logits it produces, the lanes of a row meet by
//     shuffles (the rows' reductions run side by side, so their latencies
//     overlap), and each thread exponentiates the entries it wrote, once, at
//     D = 256 straight from the registers that hold the tile's logits; the row
//     statistics (m, denominator, alpha) live in registers.
// Heads (ADM's multi-head blocks): q, k, v are [B, L, H * D] with head h on
// channels [h D, (h + 1) D); a block owns queries of one (image, head), and
// every row is read and written at the stride H * D.  H = 1 is the single-head
// layout.  D = 64 (ADM's heads): BQ = 64 or 128 as at D = 128, one float4 of
// channels a thread in p . v.
// Rows are padded by 4 floats (8 where lane pairs split the channels), which
// keeps every float4 read of a quarter warp on distinct banks and every row
// 16-byte aligned for cp.async.
#include "attn_common.cuh"

using namespace adm;

constexpr int FA_THREADS = 256;
constexpr float FA_NEG_INF = -1e30f;

static __device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// max / sum over the TX lanes that share a query row
template <int TX>
static __device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int TX>
static __device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int BQ, int TK, int IBMAX, int TXQ, int SPLIT>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ o, int L, int ib, int H, float scale) {
  // QK layout: thread (ty, txq, g) owns queries ty + TY i and keys txq + TXQ j of a tile, and of the
  // channels the float4 chunks g, g + SPLIT, ... (the SPLIT partial dots meet by shuffle); p.v layout:
  // thread (ty, tx) owns the same queries and channels 4 (tx + TX j) .. + 3, tx = txq * SPLIT + g
  constexpr int TX = TXQ * SPLIT, TY = FA_THREADS / TX, LD = D + (SPLIT == 2 ? 8 : 4), SLD = IBMAX + 4;
  constexpr int RQ = BQ / TY, RK = TK / TXQ, NC = D / (4 * TX);
  extern __shared__ __align__(16) float fa_smem[];
  float* Qs = fa_smem;          // [BQ][LD], q * scale
  float* T = Qs + BQ * LD;      // [2][TK][LD], tiles of K, then of V
  float* S = T + 2 * TK * LD;   // [BQ][SLD], the inner block's logits, then p

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX, g = tx % SPLIT, txq = tx / SPLIT;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, q0 = blockIdx.x * BQ;
  const long long RS = (long long)H * D;  // a row's stride
  const long long base = (long long)b * L * RS + (long long)h * D;
  const int nkt = ib / TK, ntiles = (L / ib) * 2 * nkt;

  // tile n of the stream: per inner block its nkt K tiles, then its nkt V tiles
  auto load_tile = [&](int n) {
    const int blk = n / (2 * nkt), r = n - blk * 2 * nkt;
    const float* src = (r >= nkt ? v : k) + base + (long long)(blk * ib + (r % nkt) * TK) * RS;
    float* dst = T + (n & 1) * TK * LD;
    for (int i = tid; i < TK * (D / 4); i += FA_THREADS) {
      const int row = i / (D / 4), c4 = i - row * (D / 4);
      cp_async16(dst + row * LD + c4 * 4, src + (long long)row * RS + c4 * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0);

  for (int i = tid; i < BQ * (D / 4); i += FA_THREADS) {
    const int r = i / (D / 4), c4 = i - r * (D / 4);
    float4 x = *reinterpret_cast<const float4*>(q + base + (long long)(q0 + r) * RS + c4 * 4);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * LD + c4 * 4) = x;
  }

  float acc[RQ][NC][4], m[RQ], den[RQ], al[RQ], rmax[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = FA_NEG_INF;
    den[i] = 0.f;
    al[i] = 0.f;
    rmax[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int n = 0; n < ntiles; ++n) {
    // tile n has landed; every thread is done with tile n - 1, whose buffer takes tile n + 1
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (n + 1 < ntiles) load_tile(n + 1);
    const float* Tn = T + (n & 1) * TK * LD;
    const int r = n % (2 * nkt);
    if (r < nkt) {
      // logits of this tile's keys
      const int kt = r * TK;
      float s[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int d4 = g; d4 < D / 4; d4 += SPLIT) {
        float4 qv[RQ], kv[RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * LD + d4 * 4);
#pragma unroll
        for (int j = 0; j < RK; ++j) kv[j] = *reinterpret_cast<const float4*>(Tn + (txq + TXQ * j) * LD + d4 * 4);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          if (SPLIT == 2) s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], 1);
          if (IBMAX != TK && i % SPLIT == g) S[(ty + TY * i) * SLD + kt + txq + TXQ * j] = s[i][j];
          rmax[i] = fmaxf(rmax[i], s[i][j]);
        }
      if (IBMAX == TK) {
        // the inner block is this one tile: its softmax runs on the logits in registers
        float mn[RQ], sum[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) mn[i] = fmaxf(m[i], row_max<TX>(rmax[i]));
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          sum[i] = 0.f;
          if (i % SPLIT == g) {
#pragma unroll
            for (int j = 0; j < RK; ++j) {
              const float e = expf(s[i][j] - mn[i]);
              S[(ty + TY * i) * SLD + txq + TXQ * j] = e;
              sum[i] += e;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) sum[i] = row_sum<TX>(sum[i]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          al[i] = expf(m[i] - mn[i]);
          den[i] = den[i] * al[i] + sum[i];
          m[i] = mn[i];
          rmax[i] = -INFINITY;
        }
      } else if (r == nkt - 1) {
        // online softmax of the inner block, each thread on the entries it wrote (columns txq + TXQ j of
        // its rows); the rows' reductions run side by side, so their shuffle latencies overlap
        float mn[RQ], sum[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) mn[i] = fmaxf(m[i], row_max<TX>(rmax[i]));
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          sum[i] = 0.f;
          if (i % SPLIT == g) {
            float* row = S + (ty + TY * i) * SLD + txq;
#pragma unroll 4
            for (int j = 0; j < ib; j += TXQ) {
              const float e = expf(row[j] - mn[i]);
              row[j] = e;
              sum[i] += e;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) sum[i] = row_sum<TX>(sum[i]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          al[i] = expf(m[i] - mn[i]);
          den[i] = den[i] * al[i] + sum[i];
          m[i] = mn[i];
          rmax[i] = -INFINITY;
        }
      }
    } else {
      // acc = acc * alpha + p . v over this tile's keys
      const int kt = (r - nkt) * TK;
      if (r == nkt) {
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] *= al[i];
      }
#pragma unroll 2
      for (int k4 = 0; k4 < TK / 4; ++k4) {
        float4 pv[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          pv[i] = *reinterpret_cast<const float4*>(S + (ty + TY * i) * SLD + kt + k4 * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 vv[NC];
#pragma unroll
          for (int j = 0; j < NC; ++j)
            vv[j] = *reinterpret_cast<const float4*>(Tn + (k4 * 4 + kk) * LD + (tx + TX * j) * 4);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y : kk == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              acc[i][j][0] = fmaf(p, vv[j].x, acc[i][j][0]);
              acc[i][j][1] = fmaf(p, vv[j].y, acc[i][j][1]);
              acc[i][j][2] = fmaf(p, vv[j].z, acc[i][j][2]);
              acc[i][j][3] = fmaf(p, vv[j].w, acc[i][j][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 r = make_float4(acc[i][j][0] / den[i], acc[i][j][1] / den[i], acc[i][j][2] / den[i],
                                   acc[i][j][3] / den[i]);
      *reinterpret_cast<float4*>(o + base + (long long)(q0 + ty + TY * i) * RS + (tx + TX * j) * 4) = r;
    }
  }
}

static int fa_gcd(int a, int b) { return b ? fa_gcd(b, a % b) : a; }

template <int D, int BQ, int TK, int IBMAX, int TXQ, int SPLIT>
static cudaError_t launch_flash(const float* q, const float* k, const float* v, float* o, int B, int L, int H,
                                int bk, float scale, cudaStream_t s) {
  // the inner block: the caller's key block, or the largest part of it that fits
  const int ib = fa_gcd(bk, IBMAX);
  if (L % BQ != 0 || ib % TK != 0 || L % bk != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * TK) * (D + (SPLIT == 2 ? 8 : 4)) + (size_t)BQ * (IBMAX + 4));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, BQ, TK, IBMAX, TXQ, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<D, BQ, TK, IBMAX, TXQ, SPLIT><<<dim3(L / BQ, B * H), FA_THREADS, smem, s>>>(q, k, v, o, L, ib,
                                                                                                   H, scale);
  return cudaGetLastError();
}

// q, k, v, out: [B, L, H * D] f32 (H heads of D channels); bk: the online softmax's key block
extern "C" int adm_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int L, int D,
                                   int H, int bk, float scale, void* stream) {
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_GO(...) return (int)launch_flash<__VA_ARGS__>(qp, kp, vp, op, B, L, H, bk, scale, s)
  // D = 128: 128 queries a block (8 x 4 register tiles in q . k^T) where that still fills the card's
  // 132 SMs, else 64; D = 256: 64 queries, the channels of q . k^T split over lane pairs
  if (H < 1) return (int)cudaErrorInvalidValue;
  if (D == 64 && H > 1) {
    if (L % 128 == 0 && (long long)(L / 128) * B * H >= 132) FA_GO(64, 128, 64, 128, 16, 1);
    FA_GO(64, 64, 64, 128, 16, 1);
  }
  if (D == 128) {
    if (L % 128 == 0 && (long long)(L / 128) * B * H >= 132) FA_GO(128, 128, 64, 128, 16, 1);
    FA_GO(128, 64, 64, 128, 16, 1);
  }
  if (D == 256) FA_GO(256, 64, 64, 64, 16, 2);
  return (int)cudaErrorInvalidValue;
}
