// int8 implicit-GEMM convolution core, shared by K1 (int8_conv.cu) and the
// q/k/v and output projections of K3 (int8_attention.cu).
//
// out[m, n] = sum_k A[m, k] * W[k, n] with m = (b, oy, ox) an output pixel,
// k = (dy, dx, c) a tap and input channel, A[m, k] = x[b, oy*s + dy,
// ox*s + dx, c] read straight from the halo-padded NHWC input (implicit
// im2col: no im2col matrix is ever written) and W the fold-layout weights
// gq [KS*KS*Cp, Np] (rows in (dy, dx, c) order).
//
// Products: mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores, exact in
// int32 (|gq| <= 8 at W4, K <= 9*512).
//
// Tiling (simple first version): a 256-thread block computes a 128 x 128
// output tile, stepping K by 32.  Eight warps in a 2 x 4 grid each own a
// 64 x 32 sub-tile (4 x 4 mma tiles, 64 int32 accumulators per thread).
// Cp is a multiple of 32, so a 32-wide K step never crosses a tap: each A
// row of the step is 32 contiguous input bytes, loaded as two 16-byte
// vectors.  W is stored k-major in memory while the mma's B operand wants
// 4 consecutive k per register, so each thread loads a 4(k) x 4(n) byte
// patch and transposes it with __byte_perm on its way to shared memory.
// Shared rows are padded to 48 bytes, which makes the fragment reads
// bank-conflict free.  The next step's global loads are issued before the
// current step's mma's (register double buffering).
//
// What bounds it on the H100: at the serving shapes (B = 128, M up to
// 131072, K = 9*Cp up to 4608, N = 128 or 256) the work is tensor-core
// arithmetic plus one pass over the input per N tile; mma.sync without TMA
// or wgmma reaches a fraction of the int8 peak.  wgmma, TMA and persistent
// blocks are later work.
#pragma once

#include "common.cuh"

namespace adm {

enum Epilogue : int {
  EPI_I32 = 0,        // raw int32 accumulator
  EPI_BF16 = 1,       // bf16(acc * inv_ws + zcbias)
  EPI_F32 = 2,        // acc * inv_ws + zcbias in f32
  EPI_RESADD_BF16 = 3 // bf16(res + (acc * inv_ws + zcbias))
};

struct IgemmArgs {
  const int8_t* x;           // [B, Hp, Wp, Cp] int8, halo already applied
  const int8_t* w;           // [KS*KS*Cp, Np] int8
  const float* inv_ws;       // [Np] (not read by EPI_I32)
  const float* zcbias;       // [Np] (not read by EPI_I32)
  const __nv_bfloat16* res;  // [M, Np] (EPI_RESADD_BF16 only)
  void* out;                 // [M, Np]
  int B, Hp, Wp, Cp, Ho, Wo, Np, stride;
};

constexpr int IG_BM = 128, IG_BN = 128, IG_BK = 32, IG_LDS = 48, IG_THREADS = 256;

static __device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KS, int MODE>
__global__ void __launch_bounds__(IG_THREADS) igemm_kernel(IgemmArgs a) {
  __shared__ __align__(16) int8_t As[IG_BM * IG_LDS];
  __shared__ __align__(16) int8_t Bs[IG_BN * IG_LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.B * a.Ho * a.Wo;
  const int m0 = blockIdx.x * IG_BM, n0 = blockIdx.y * IG_BN;
  const int nk = KS * KS * a.Cp / IG_BK;

  // A loader: one output row and one 16-byte half of the 32-byte K step
  const int a_row = tid >> 1, a_half = tid & 1;
  const int m = m0 + a_row;
  const bool a_valid = m < M;
  long long a_base = 0;  // input offset of tap (0, 0) for this output pixel
  if (a_valid) {
    const int hw = a.Ho * a.Wo;
    const int b = m / hw, r = m - b * hw, oy = r / a.Wo, ox = r - oy * a.Wo;
    a_base = ((long long)(b * a.Hp + oy * a.stride) * a.Wp + ox * a.stride) * a.Cp;
  }
  // B loader: a 4(k) x 4(n) byte patch
  const int b_k = (tid >> 5) * 4, b_n = (tid & 31) * 4;

  int4 ra = make_int4(0, 0, 0, 0);
  uint32_t rb[4];

  auto load = [&](int k0) {
    const int tap = k0 / a.Cp, c0 = k0 - tap * a.Cp;
    const int dy = tap / KS, dx = tap - dy * KS;
    if (a_valid)
      ra = *reinterpret_cast<const int4*>(a.x + a_base + ((long long)dy * a.Wp + dx) * a.Cp + c0 + a_half * 16);
    const int8_t* q = a.w + (long long)(k0 + b_k) * a.Np + n0 + b_n;
#pragma unroll
    for (int j = 0; j < 4; ++j) rb[j] = *reinterpret_cast<const uint32_t*>(q + (long long)j * a.Np);
  };

  auto store = [&]() {
    *reinterpret_cast<int4*>(&As[a_row * IG_LDS + a_half * 16]) = ra;
    // rb[j] = W[k + j][n .. n+3]; column i of the patch = bytes i of rb[0..3]
    const uint32_t t0 = __byte_perm(rb[0], rb[1], 0x5140);
    const uint32_t t1 = __byte_perm(rb[0], rb[1], 0x7362);
    const uint32_t t2 = __byte_perm(rb[2], rb[3], 0x5140);
    const uint32_t t3 = __byte_perm(rb[2], rb[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i) *reinterpret_cast<uint32_t*>(&Bs[(b_n + i) * IG_LDS + b_k]) = col[i];
  };

  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * IG_BK);
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = warp_m * 64 + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r * IG_LDS + t * 4]);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[(r + 8) * IG_LDS + t * 4]);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r * IG_LDS + t * 4 + 16]);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[(r + 8) * IG_LDS + t * 4 + 16]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int cn = warp_n * 32 + ni * 8 + g;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cn * IG_LDS + t * 4]);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cn * IG_LDS + t * 4 + 16]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  // epilogue: acc[mi][ni][2h + {0,1}] is (row g + 8h, cols 2t, 2t + 1) of the mma tile
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp_n * 32 + ni * 8 + t * 2;
        const long long o = (long long)row * a.Np + col;
        const int v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (MODE == EPI_I32) {
          *reinterpret_cast<int2*>(static_cast<int*>(a.out) + o) = make_int2(v0, v1);
        } else {
          const float f0 = __int2float_rn(v0) * a.inv_ws[col] + a.zcbias[col];
          const float f1 = __int2float_rn(v1) * a.inv_ws[col + 1] + a.zcbias[col + 1];
          if (MODE == EPI_BF16) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + o) =
                __floats2bfloat162_rn(f0, f1);
          } else if (MODE == EPI_F32) {
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = make_float2(f0, f1);
          } else {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.res + o));
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + o) =
                __floats2bfloat162_rn(r.x + f0, r.y + f1);
          }
        }
      }
    }
}

template <int KS, int MODE>
static cudaError_t launch_igemm(const IgemmArgs& a, cudaStream_t stream) {
  const int M = a.B * a.Ho * a.Wo;
  dim3 grid((M + IG_BM - 1) / IG_BM, a.Np / IG_BN);
  igemm_kernel<KS, MODE><<<grid, IG_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace adm
