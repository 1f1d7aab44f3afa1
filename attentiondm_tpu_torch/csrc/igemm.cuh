// int8 implicit-GEMM convolution core, shared by K1 (int8_conv.cu; K13 and K5
// are its int32 3x3 and 1x1 modes), the q/k/v and output projections of K3
// (int8_attention.cu) and the two GEMMs of K12 (resblock.cu).
//
// Replaces the matrix products of the TPU kernel
// attentiondm_tpu/ops/pallas_conv.py int8_conv3_pallas (9 MXU dots over a halo
// tile held in VMEM).
//
// out[m, n] = sum_k A[m, k] * W[k, n] in exact int32, with m = (b, oy, ox) an
// output pixel, k = (dy, dx, c) a tap and input channel, and A[m, k] =
// x[b, oy*s + dy, ox*s + dx, c] read straight from the halo-padded NHWC input
// (implicit im2col: no im2col matrix is ever written).  The weights arrive
// K-major, wt [Np, KS*KS*Cp] (the transpose of the fold layout gq, made once
// at fold time): wgmma takes 8-bit operands only with K contiguous, so the
// kernel transposes nothing.
//
// What bounds it on the H100: tensor-core operations (2*M*K*Np int8 at 1,979
// TOP/s) at the 3x3 shapes, bytes at the 1x1 shapes.  The design, for Hopper:
//   - products by wgmma.mma_async m64n128k32 s8 x s8 -> s32, both operands
//     read from shared memory through 128-byte-swizzle descriptors, the
//     accumulator (64 int32 a thread) in registers;
//   - a ring of stages in dynamic shared memory (3 of 32 KB at BM = 128, 4 of
//     24 KB at BM = 64: two blocks fit an SM, so one block's epilogue runs
//     under the other's products), each stage one A tile (BM rows x 128 bytes
//     of K) and one B tile (128 output channels x 128 bytes of K).  Cp is a
//     multiple of 128, so a 128-byte K step never crosses a tap;
//   - one producer warp fills the ring with TMA loads and mbarriers (full /
//     empty per stage); one consumer warpgroup per 64 rows runs the wgmma's
//     and keeps one group in flight;
//   - the implicit im2col is a TMA box load: the input is a 4-D tensor
//     (c, x, y, b), an M tile covers `imgs` images x `rows` output rows x
//     `cols` output columns (IgemmTile, chosen by ops/pallas_conv.conv_tiles),
//     and tap (dy, dx) of it is the box (128, cols, rows, imgs) at
//     (c0, ox0 + dx, oy0 + dy, b0).  Boxes past an edge are zero-filled by the
//     hardware and their rows masked in the epilogue.  Stride 2 reads four
//     parity views of the input (x = 2 i + px, y = 2 j + py: a tensor map each,
//     with doubled global strides), so no element-stride semantics are relied
//     on.  A 1x1 conv is the flat GEMM over M = B*H*W rows;
//   - BM = 64 where 128-row tiles would leave SMs idle (the 4x4 and 8x8 maps);
//     no split-K: the int32 sums stay exact and deterministic;
//   - epilogue: inv_ws / zcbias of the tile's 128 columns staged once in
//     shared memory; a lane pair swaps halves so that each thread owns 4
//     consecutive columns of one row and stores 16 bytes (int32, f32) or 8
//     (bf16).  acc * inv_ws + zcbias in f32, the product rounded before the
//     sum (-fmad=false), one rounding to bf16; the residual-add modes add the
//     residual row (bf16 or f32, read as the output is written) to that sum,
//     and round once to bf16 or not at all (f32).
// The tensor maps are encoded on the host inside the launcher, per call
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda) and
// passed as __grid_constant__ parameters; the encodes cost the wrapper a few
// microseconds, so no cache of maps is kept.
// Left out on purpose: a 256-channel tile (128 accumulators a thread would put
// one block on an SM and expose every epilogue; it would halve the A tiles'
// L2 traffic where Np >= 256), a persistent tile loop (two resident blocks an
// SM already overlap epilogue and products) and 16-byte bf16 stores (a thread
// owns 4 consecutive columns, 8 bytes in bf16).  What holds the kernel under
// its bound on the H100 (measured 12% of it at the 4x4 maps, 31% at Cp = Np =
// 128 over 32x32, 40 to 60% at the large shapes, 68 to 83% at the 1x1 shapes):
// each of the 9 taps re-reads its A tile from L2, and a K loop of 9 steps
// leaves the ring's fill and the epilogue exposed.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace adm {

enum Epilogue : int {
  EPI_I32 = 0,        // raw int32 accumulator
  EPI_BF16 = 1,       // bf16(acc * inv_ws + zcbias)
  EPI_F32 = 2,        // acc * inv_ws + zcbias in f32
  EPI_RESADD_BF16 = 3, // bf16(res + (acc * inv_ws + zcbias)), res bf16
  EPI_RESADD_F32 = 4   // res + (acc * inv_ws + zcbias) in f32, res f32: nothing rounds but the f32 operations
};

// An M tile: BM accumulator rows, of which cols * rows * imgs are output
// pixels (ox0 .. + cols, oy0 .. + rows, b0 .. + imgs), row r of the tile being
// pixel (r / (cols * rows), r / cols % rows, r % cols).
struct IgemmTile {
  int bm, cols, rows, imgs;
};

struct IgemmArgs {
  const int8_t* x;           // [B, Hp, Wp, Cp] int8, halo already applied
  const int8_t* wt;          // [Np, KS*KS*Cp] int8, K-major
  const float* inv_ws;       // [Np] (not read by EPI_I32)
  const float* zcbias;       // [Np] (not read by EPI_I32)
  const void* res;           // [M, Np]: bf16 (EPI_RESADD_BF16) or f32 (EPI_RESADD_F32); read by those modes only
  void* out;                 // [M, Np]
  int B, Hp, Wp, Cp, Ho, Wo, Np, stride;
  IgemmTile tile;
};

struct IgemmMaps {
  CUtensorMap a[4];  // the input; stride 2: the (py, px) parity views
  CUtensorMap w;     // the K-major weights
};

constexpr int IG_BN = 128, IG_BK = 128;
__host__ __device__ constexpr int ig_stages(int bm) { return bm == 128 ? 3 : 4; }
__host__ __device__ constexpr int ig_stage_bytes(int bm) { return (bm + IG_BN) * IG_BK; }
__host__ __device__ constexpr int ig_smem_bytes(int bm) {
  return 1024 + ig_stages(bm) * ig_stage_bytes(bm) + 2 * IG_BN * 4 + 2 * ig_stages(bm) * 8;
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

static __device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                                   int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile of 128-byte rows under the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused
static __device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define IG_R8(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
                    "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64] += A (64 x 32 s8, shared) . B (128 x 32 s8, shared)^T
static __device__ __forceinline__ void wgmma_m64n128k32_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : IG_R8(d, 0), IG_R8(d, 8), IG_R8(d, 16), IG_R8(d, 24), IG_R8(d, 32), IG_R8(d, 40), IG_R8(d, 48), IG_R8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

template <int KS, int MODE, int BM>
__global__ void __launch_bounds__(BM * 2 + 32)
igemm_kernel(const __grid_constant__ IgemmMaps maps, const IgemmArgs a) {
  constexpr int NWG = BM / 64, STAGES = ig_stages(BM), STAGE = ig_stage_bytes(BM), A_BYTES = BM * IG_BK;
  extern __shared__ uint8_t ig_raw[];
  // the swizzle is a function of the address: stages start on 1024 bytes
  const uint32_t raw = smem_u32(ig_raw), ring = (raw + 1023u) & ~1023u;
  float* epi = reinterpret_cast<float*>(ig_raw + (ring - raw) + STAGES * STAGE);  // inv_ws[BN], zcbias[BN]
  const uint32_t full = ring + STAGES * STAGE + 2 * IG_BN * 4, empty = full + STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const IgemmTile t = a.tile;
  const int NT = a.Np / IG_BN, nt = blockIdx.x % NT;
  int mt = blockIdx.x / NT;
  const int tiles_x = (a.Wo + t.cols - 1) / t.cols, tiles_y = (a.Ho + t.rows - 1) / t.rows;
  const int ox0 = (mt % tiles_x) * t.cols;
  mt /= tiles_x;
  const int oy0 = (mt % tiles_y) * t.rows, b0 = (mt / tiles_y) * t.imgs;
  const int n0 = nt * IG_BN;

  if (MODE != EPI_I32)
    for (int i = tid; i < IG_BN; i += blockDim.x) {
      epi[i] = a.inv_ws[n0 + i];
      epi[IG_BN + i] = a.zcbias[n0 + i];
    }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, NWG * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int cpk = a.Cp / IG_BK, nk = KS * KS * cpk;
  if (warp == NWG * 4) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)(t.cols * t.rows * t.imgs) * IG_BK + IG_BN * IG_BK;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + s * 8, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s * 8, bytes);
        const int tap = kt / cpk, c0 = (kt - tap * cpk) * IG_BK, dy = tap / KS, dx = tap - dy * KS;
        const CUtensorMap* map = &maps.a[0];
        int cx = ox0 + dx, cy = oy0 + dy;
        if (a.stride == 2) {
          map = &maps.a[(dy & 1) * 2 + (dx & 1)];
          cx = ox0 + (dx >> 1);
          cy = oy0 + (dy >> 1);
        }
        const uint32_t dst = ring + s * STAGE;
        tma_load_4d(dst, map, full + s * 8, c0, cx, cy, b0);
        tma_load_2d(dst + A_BYTES, &maps.w, full + s * 8, kt * IG_BK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + s * 8, (kt / STAGES) & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t da = wgmma_desc(ring + s * STAGE + wg * 64 * IG_BK), db = wgmma_desc(ring + s * STAGE + A_BYTES);
#pragma unroll
    for (int kk = 0; kk < IG_BK / 32; ++kk) wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kt > 0) {  // the step before has finished reading its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty + ((kt - 1) % STAGES) * 8);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // epilogue.  acc[4 j + {0, 1}] is (row g, cols 8 j + 2 q + {0, 1}) and
  // acc[4 j + {2, 3}] the same columns of row g + 8 (g = lane / 4, q = lane %
  // 4, rows within the warp's 16); lanes q and q ^ 1 swap halves, so an even q
  // owns row g and an odd q row g + 8, columns 8 j + 4 (q / 2) .. + 3.
  const int q = lane & 3, odd = q & 1;
  const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + odd * 8;
  const int per_img = t.cols * t.rows;
  const int ib = r / per_img, rr = r - ib * per_img, iy = rr / t.cols, ix = rr - iy * t.cols;
  const bool valid = ib < t.imgs && b0 + ib < a.B && oy0 + iy < a.Ho && ox0 + ix < a.Wo;
  const long long row_off = (((long long)(b0 + ib) * a.Ho + oy0 + iy) * a.Wo + ox0 + ix) * a.Np + n0;
#pragma unroll
  for (int j = 0; j < IG_BN / 8; ++j) {
    const int s0 = odd ? acc[4 * j] : acc[4 * j + 2], s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const int r0 = __shfl_xor_sync(0xffffffffu, s0, 1), r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const int v0 = odd ? r0 : acc[4 * j], v1 = odd ? r1 : acc[4 * j + 1];
    const int v2 = odd ? acc[4 * j + 2] : r0, v3 = odd ? acc[4 * j + 3] : r1;
    if (!valid) continue;
    const int col = 8 * j + 4 * (q >> 1);
    const long long o = row_off + col;
    if (MODE == EPI_I32) {
      *reinterpret_cast<int4*>(static_cast<int*>(a.out) + o) = make_int4(v0, v1, v2, v3);
    } else {
      const float4 iw = *reinterpret_cast<const float4*>(epi + col);
      const float4 zc = *reinterpret_cast<const float4*>(epi + IG_BN + col);
      float f0 = __int2float_rn(v0) * iw.x + zc.x, f1 = __int2float_rn(v1) * iw.y + zc.y;
      float f2 = __int2float_rn(v2) * iw.z + zc.z, f3 = __int2float_rn(v3) * iw.w + zc.w;
      if (MODE == EPI_F32) {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) = make_float4(f0, f1, f2, f3);
      } else if (MODE == EPI_RESADD_F32) {
        const float4 rv = *reinterpret_cast<const float4*>(static_cast<const float*>(a.res) + o);
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
            make_float4(rv.x + f0, rv.y + f1, rv.z + f2, rv.w + f3);
      } else {
        if (MODE == EPI_RESADD_BF16) {
          const uint2 rv = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a.res) + o);
          const float2 ra = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.x));
          const float2 rb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.y));
          f0 = ra.x + f0;
          f1 = ra.y + f1;
          f2 = rb.x + f2;
          f3 = rb.y + f3;
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(f0, f1), hi = __floats2bfloat162_rn(f2, f3);
        uint2 ov;
        ov.x = *reinterpret_cast<const uint32_t*>(&lo);
        ov.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) = ov;
      }
    }
  }
}

typedef CUresult (*IgEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline IgEncodeTiled ig_encoder() {
  static IgEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<IgEncodeTiled>(p);
  }
  return fn;
}

// an int8 tensor map of `rank` dimensions (innermost first), 128-byte swizzle, zero fill
static inline bool ig_encode(CUtensorMap* m, const void* base, int rank, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box) {
  IgEncodeTiled enc = ig_encoder();
  if (!enc) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS, int MODE, int BM>
static cudaError_t launch_igemm_tile(const IgemmMaps& maps, const IgemmArgs& a, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(igemm_kernel<KS, MODE, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           ig_smem_bytes(BM));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const IgemmTile& t = a.tile;
  const long long tiles = (long long)((a.Wo + t.cols - 1) / t.cols) * ((a.Ho + t.rows - 1) / t.rows) *
                          ((a.B + t.imgs - 1) / t.imgs) * (a.Np / IG_BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  igemm_kernel<KS, MODE, BM><<<(unsigned)tiles, BM * 2 + 32, ig_smem_bytes(BM), stream>>>(maps, a);
  return cudaGetLastError();
}

// `a` describes the conv as the caller sees it; a 1x1 conv runs as the flat
// GEMM over its B*Hp*Wp rows, which is the geometry `a.tile` is given in.
template <int KS, int MODE>
static cudaError_t launch_igemm(IgemmArgs a, cudaStream_t stream) {
  if (KS == 1) {
    if (a.stride != 1) return cudaErrorInvalidValue;
    a.Wp = a.Wo = a.B * a.Hp * a.Wp;
    a.B = a.Hp = a.Ho = 1;
  }
  const IgemmTile& t = a.tile;
  if (a.Cp % IG_BK != 0 || a.Np % IG_BN != 0 || (t.bm != 64 && t.bm != 128) || t.cols < 1 || t.rows < 1 ||
      t.imgs < 1 || t.cols > 256 || t.rows > 256 || t.imgs > 256 || t.cols * t.rows * t.imgs > t.bm ||
      (a.stride != 1 && a.stride != 2))
    return cudaErrorInvalidValue;

  IgemmMaps maps;
  const cuuint64_t K = (cuuint64_t)KS * KS * a.Cp;
  const cuuint64_t wdims[2] = {K, (cuuint64_t)a.Np}, wstrides[1] = {K};
  const cuuint32_t wbox[2] = {IG_BK, IG_BN};
  if (!ig_encode(&maps.w, a.wt, 2, wdims, wstrides, wbox)) return cudaErrorInvalidValue;
  const cuuint32_t abox[4] = {IG_BK, (cuuint32_t)t.cols, (cuuint32_t)t.rows, (cuuint32_t)t.imgs};
  const cuuint64_t s = (cuuint64_t)a.stride, Cp = (cuuint64_t)a.Cp, Wp = (cuuint64_t)a.Wp, Hp = (cuuint64_t)a.Hp;
  for (int v = 0; v < (a.stride == 2 ? 4 : 1); ++v) {
    const cuuint64_t py = v >> 1, px = v & 1;  // the view x = s i + px, y = s j + py
    const cuuint64_t dims[4] = {Cp, (Wp - px + s - 1) / s, (Hp - py + s - 1) / s, (cuuint64_t)a.B};
    const cuuint64_t strides[3] = {s * Cp, s * Wp * Cp, Hp * Wp * Cp};
    if (!ig_encode(&maps.a[v], a.x + (py * Wp + px) * Cp, 4, dims, strides, abox)) return cudaErrorInvalidValue;
  }
  if (t.bm == 128) return launch_igemm_tile<KS, MODE, 128>(maps, a, stream);
  return launch_igemm_tile<KS, MODE, 64>(maps, a, stream);
}

}  // namespace adm
