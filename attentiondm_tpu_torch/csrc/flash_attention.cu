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
// Here a block of 256 threads owns BQ queries of one image.  The logits of
// one key block (BQ x bk, bk <= 512) live in shared memory, because the
// block's row maximum has to be known before any of its p; K and then V
// stream through one shared tile of TK keys.  Both products are register
// tiled: thread (ty, tx) of a 16 x 16 layout owns queries ty + 16 i and, in
// q . k^T, keys tx + 16 j of the tile (float4 steps along the channels), in
// p . v, channels 4 (tx + 16 j) .. + 3.  The accumulator (BQ x D f32) stays in
// registers, so tiles are sized from D: 64 queries at D = 128, 32 at D = 256.
// Rows are padded by 4 floats, which keeps every float4 read of a quarter
// warp on distinct banks.
//
// What bounds it on the H100: operations, 4 L^2 D f32 per image on the CUDA
// cores (fmaf; the tensor cores have no f32 mode) against 16 L D bytes.
// One block per SM and no overlap of the tile loads with the arithmetic keep
// it well under the f32 peak; a TF32x3 or bf16x3 split on the tensor cores
// and cp.async double buffering are later work.
#include "attn_common.cuh"

using namespace adm;

constexpr int FA_THREADS = 256, FA_BK = 512, FA_SLD = FA_BK + 4;
constexpr float FA_NEG_INF = -1e30f;

template <int D, int BQ, int TK>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ o, int L, int bk, float scale) {
  constexpr int LD = D + 4, RQ = BQ / 16, RK = TK / 16, NC = D / 64;
  extern __shared__ __align__(16) float fa_smem[];
  float* Qs = fa_smem;           // [BQ][LD], q * scale
  float* T = Qs + BQ * LD;       // [TK][LD], a tile of K, then of V
  float* S = T + TK * LD;        // [BQ][FA_SLD], the block's logits, then p
  float* m_s = S + BQ * FA_SLD;  // [BQ] running maximum, denominator, and the block's alpha
  float* den_s = m_s + BQ;
  float* al_s = den_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long base = (long long)b * L * D;

  for (int i = tid; i < BQ * (D / 4); i += FA_THREADS) {
    const int r = i / (D / 4), c4 = i - r * (D / 4);
    float4 x = *reinterpret_cast<const float4*>(q + base + (long long)(q0 + r) * D + c4 * 4);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * LD + c4 * 4) = x;
  }
  if (tid < BQ) {
    m_s[tid] = FA_NEG_INF;
    den_s[tid] = 0.f;
  }
  auto load_tile = [&](const float* src, int k0) {
    for (int i = tid; i < TK * (D / 4); i += FA_THREADS) {
      const int r = i / (D / 4), c4 = i - r * (D / 4);
      *reinterpret_cast<float4*>(T + r * LD + c4 * 4) =
          *reinterpret_cast<const float4*>(src + base + (long long)(k0 + r) * D + c4 * 4);
    }
  };

  float acc[RQ][NC][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kb = 0; kb < L; kb += bk) {
    // the block's logits
    for (int kt = 0; kt < bk; kt += TK) {
      __syncthreads();
      load_tile(k, kb + kt);
      __syncthreads();
      float s[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < D / 4; ++d4) {
        float4 qv[RQ], kv[RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d4 * 4);
#pragma unroll
        for (int j = 0; j < RK; ++j) kv[j] = *reinterpret_cast<const float4*>(T + (tx + 16 * j) * LD + d4 * 4);
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
        for (int j = 0; j < RK; ++j) S[(ty + 16 * i) * FA_SLD + kt + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    // online softmax of the block, one warp a row
    for (int r = warp; r < BQ; r += FA_THREADS / 32) {
      float* row = S + r * FA_SLD;
      float mx = -INFINITY;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, row[j]);
      const float mo = m_s[r], mn = fmaxf(mo, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float e = expf(row[j] - mn);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(mo - mn);
        al_s[r] = al;
        den_s[r] = den_s[r] * al + sum;
        m_s[r] = mn;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . v
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float al = al_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= al;
    }
    for (int kt = 0; kt < bk; kt += TK) {
      if (kt) __syncthreads();
      load_tile(v, kb + kt);
      __syncthreads();
#pragma unroll 2
      for (int k4 = 0; k4 < TK / 4; ++k4) {
        float4 pv[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          pv[i] = *reinterpret_cast<const float4*>(S + (ty + 16 * i) * FA_SLD + kt + k4 * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 vv[NC];
#pragma unroll
          for (int j = 0; j < NC; ++j)
            vv[j] = *reinterpret_cast<const float4*>(T + (k4 * 4 + kk) * LD + (tx + 16 * j) * 4);
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
    const float den = den_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 r = make_float4(acc[i][j][0] / den, acc[i][j][1] / den, acc[i][j][2] / den, acc[i][j][3] / den);
      *reinterpret_cast<float4*>(o + base + (long long)(q0 + ty + 16 * i) * D + (tx + 16 * j) * 4) = r;
    }
  }
}

template <int D, int BQ, int TK>
static cudaError_t launch_flash(const float* q, const float* k, const float* v, float* o, int B, int L, int bk,
                                float scale, cudaStream_t s) {
  if (L % BQ != 0 || bk % TK != 0 || bk > FA_BK || L % bk != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(BQ + TK) * (D + 4) + (size_t)BQ * FA_SLD + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, BQ, TK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<D, BQ, TK><<<dim3(L / BQ, B), FA_THREADS, smem, s>>>(q, k, v, o, L, bk, scale);
  return cudaGetLastError();
}

// q, k, v, out: [B, L, D] f32; bk: the online softmax's key block
extern "C" int adm_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int L, int D,
                                   int bk, float scale, void* stream) {
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_flash<128, 64, 64>(qp, kp, vp, op, B, L, bk, scale, s);
  if (D == 256) return (int)launch_flash<256, 32, 64>(qp, kp, vp, op, B, L, bk, scale, s);
  return (int)cudaErrorInvalidValue;
}
