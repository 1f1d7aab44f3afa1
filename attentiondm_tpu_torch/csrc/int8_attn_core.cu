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
// On the TPU one program held whole images (K8, K9) or a 256-query block
// with all of K and V (K10) in VMEM.  Here one core kernel serves the three:
// a block owns 64 queries of one image and streams K and V in tiles of 64
// keys through shared memory; warp w owns 16 of the queries (w % 4) and 128
// of the channels (w / 4), so a block has C / 32 warps.  The logits of a tile
// stay in registers: the accumulator layout of mma.m16n8k32 (s8) is the A
// operand layout of mma.m16n8k16 (bf16), so p goes from the first product to
// the second without touching shared memory.  V lands in shared memory
// transposed (channel-major), the B operand's layout.
//
// The order of roundings is each TPU kernel's own, because the bf16 cast of
// p is a discontinuity:
//   K8 / K9 (NORM): the row maximum over all keys, e = exp(lf - m), p = e
//       divided by the row sum, then the cast; K9 multiplies by sv after PV.
//       Three sweeps over the keys (maximum, sum, PV), each recomputing the
//       integer logits, which is exact; keeping a row's L f32 logits instead
//       (8 KB a query at L = 2048, 512 KB a block) would not fit.
//   K10 (online): per block of bk keys, m_new = max(m, block maximum),
//       alpha = exp(m - m_new), un-normalised p = exp(lf - m_new) cast to
//       bf16, denom = denom * alpha + sum(p), acc = acc * alpha + p . v, and
//       acc / denom * sv at the end; m starts at -1e30.  Two sweeps a block
//       (maximum, then PV).
// The row maximum is taken over the integers: float(x) * ls is monotone in x
// for ls >= 0 (the scales are absmax / 127 > 0), so max(lf) is
// float(max(logits)) * ls to the bit.
//
// What bounds it on the H100: operations (2 L^2 C int8 and 2 L^2 C bf16 per
// image against 4 L C bytes); mma.sync from shared-memory fragments, with
// the recomputed logits, reaches a fraction of the tensor cores' peak.
// wgmma, TMA and a pipelined ring of tiles are later work.  Registers (nvcc
// 12.8, -Xptxas -v): the C = 128 and C = 256 instantiations do not spill; at
// C = 512 (16 warps, 512 threads a block) the whole-softmax kernels spill 164
// bytes of stores and 116 of loads a thread, the online one 68 and 64.  No
// serving path of a shipped config reaches C = 512 here.
#include <limits.h>

#include "attn_common.cuh"

using namespace adm;

constexpr int IA_BQ = 64, IA_TK = 64;
constexpr int IA_VS = IA_TK + 8;  // V^T row stride in bf16: fragment reads and tile writes hit 32 banks
constexpr float IA_NEG_INF = -1e30f;

struct CoreArgs {
  const int8_t* q8;  // [B, L, C]
  const int8_t* k8;
  const void* v;            // [B, L, C] int8 (static) or bf16 (dynamic)
  const float* sc;          // static: (sq, sk, sv); nullptr when dynamic
  const unsigned* amax;     // dynamic: [B, 2] absolute maxima of q and k (bits)
  const float* out_scale;   // [C]
  const float* out_zp;      // [C]
  int8_t* out;              // [B, L, C]
  int L, bk, n_out;
  float scale;
};

static __device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

static __device__ __forceinline__ __nv_bfloat16 v_bf16(int8_t v) { return __float2bfloat16_rn((float)v); }
static __device__ __forceinline__ __nv_bfloat16 v_bf16(__nv_bfloat16 v) { return v; }

static __device__ __forceinline__ int quad_max(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

static __device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int C, typename VT, bool NORM>
__global__ void __launch_bounds__(C) int8_attn_core_kernel(CoreArgs a) {
  constexpr int NT = C, NW = C / 32;
  constexpr int QLD = C + 16;  // bytes per Q / K row in shared memory: fragment reads hit 32 banks
  extern __shared__ __align__(16) unsigned char ia_smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(ia_smem);                          // [BQ][QLD]
  int8_t* Ks = Qs + IA_BQ * QLD;                                            // [TK][QLD]
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(Ks + IA_TK * QLD);   // [C][VS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp & 3, cc = warp >> 2;  // the warp's 16 queries and 128 channels
  const int b = blockIdx.y, q0 = blockIdx.x * IA_BQ;
  const long long img = (long long)b * a.L * C;
  const VT* V = static_cast<const VT*>(a.v);

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

  for (int i = tid; i < IA_BQ * (C / 16); i += NT) {
    const int r = i / (C / 16), c16 = i - r * (C / 16);
    *reinterpret_cast<int4*>(Qs + r * QLD + c16 * 16) =
        *reinterpret_cast<const int4*>(a.q8 + img + (long long)(q0 + r) * C + c16 * 16);
  }

  auto load_k = [&](int k0) {
    for (int i = tid; i < IA_TK * (C / 16); i += NT) {
      const int r = i / (C / 16), c16 = i - r * (C / 16);
      *reinterpret_cast<int4*>(Ks + r * QLD + c16 * 16) =
          *reinterpret_cast<const int4*>(a.k8 + img + (long long)(k0 + r) * C + c16 * 16);
    }
  };
  // V^T: a warp-iteration moves 8 channels x 4 key pairs; lane -> (channel lane % 8, key pair lane / 8)
  auto load_v = [&](int k0) {
    for (int tile = warp; tile < C; tile += NW) {
      const int c = (tile % (C / 8)) * 8 + (lane & 7);
      const int kp = (tile / (C / 8)) * 4 + (lane >> 3);
      const VT* src = V + img + (long long)(k0 + 2 * kp) * C + c;
      *reinterpret_cast<uint32_t*>(Vt + c * IA_VS + 2 * kp) = pack_bf16(v_bf16(src[0]), v_bf16(src[C]));
    }
  };
  // s[nt][..]: logits of the warp's 16 queries against keys nt * 8 .. + 7 of the tile
  auto qk = [&](int (&s)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0;
#pragma unroll 4
    for (int kk = 0; kk < C / 32; ++kk) {
      const int8_t* qr = Qs + (rt * 16 + g) * QLD + kk * 32 + t * 4;
      const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(qr), *reinterpret_cast<const uint32_t*>(qr + 8 * QLD),
                              *reinterpret_cast<const uint32_t*>(qr + 16),
                              *reinterpret_cast<const uint32_t*>(qr + 8 * QLD + 16)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* kr = Ks + (nt * 8 + g) * QLD + kk * 32 + t * 4;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr), *reinterpret_cast<const uint32_t*>(kr + 16)};
        mma_s8(s[nt], af, bf);
      }
    }
  };

  float acc[16][4];  // [channel tile of 8][rows g (0, 1) and g + 8 (2, 3)]
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n2][j] = 0.f;
  float m0 = IA_NEG_INF, m1 = IA_NEG_INF, den0 = 0.f, den1 = 0.f;
  int s[8][4];

  const int nsub = a.bk / IA_TK;
  for (int kb = 0; kb < a.L; kb += a.bk) {
    // sweep 1: the block's row maxima, over the integer logits
    int i0 = INT_MIN, i1 = INT_MIN;
    for (int sub = 0; sub < nsub; ++sub) {
      __syncthreads();
      load_k(kb + sub * IA_TK);
      __syncthreads();
      qk(s);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        i0 = max(i0, max(s[nt][0], s[nt][1]));
        i1 = max(i1, max(s[nt][2], s[nt][3]));
      }
    }
    const float mn0 = fmaxf(m0, (float)quad_max(i0) * ls), mn1 = fmaxf(m1, (float)quad_max(i1) * ls);
    float tot0 = 1.f, tot1 = 1.f;
    if (NORM) {
      // sweep 2: the row sums of e = exp(lf - m)
      float z0 = 0.f, z1 = 0.f;
      for (int sub = 0; sub < nsub; ++sub) {
        __syncthreads();
        load_k(kb + sub * IA_TK);
        __syncthreads();
        qk(s);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          z0 += expf((float)s[nt][0] * ls - mn0);
          z0 += expf((float)s[nt][1] * ls - mn0);
          z1 += expf((float)s[nt][2] * ls - mn1);
          z1 += expf((float)s[nt][3] * ls - mn1);
        }
      }
      tot0 = quad_sum(z0);
      tot1 = quad_sum(z1);
    } else {
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      den0 = den0 * al0;
      den1 = den1 * al1;
#pragma unroll
      for (int n2 = 0; n2 < 16; ++n2) {
        acc[n2][0] *= al0;
        acc[n2][1] *= al0;
        acc[n2][2] *= al1;
        acc[n2][3] *= al1;
      }
    }
    m0 = mn0;
    m1 = mn1;
    // last sweep: p, cast to bf16, and p . v
    float z0 = 0.f, z1 = 0.f;
    for (int sub = 0; sub < nsub; ++sub) {
      __syncthreads();
      load_k(kb + sub * IA_TK);
      load_v(kb + sub * IA_TK);
      __syncthreads();
      qk(s);
      float p[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        p[nt][0] = expf((float)s[nt][0] * ls - m0);
        p[nt][1] = expf((float)s[nt][1] * ls - m0);
        p[nt][2] = expf((float)s[nt][2] * ls - m1);
        p[nt][3] = expf((float)s[nt][3] * ls - m1);
        if (NORM) {
          p[nt][0] = p[nt][0] / tot0;
          p[nt][1] = p[nt][1] / tot0;
          p[nt][2] = p[nt][2] / tot1;
          p[nt][3] = p[nt][3] / tot1;
        } else {
          z0 += p[nt][0] + p[nt][1];
          z1 += p[nt][2] + p[nt][3];
        }
      }
#pragma unroll
      for (int ks = 0; ks < IA_TK / 16; ++ks) {
        const uint32_t af[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]), pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                                pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                                pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < 16; ++n2) {
          const __nv_bfloat16* vr = Vt + (cc * 128 + n2 * 8 + g) * IA_VS + ks * 16 + 2 * t;
          mma_bf16(acc[n2], af, *reinterpret_cast<const uint32_t*>(vr), *reinterpret_cast<const uint32_t*>(vr + 8));
        }
      }
    }
    if (!NORM) {
      den0 += quad_sum(z0);
      den1 += quad_sum(z1);
    }
  }

#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) {
    const int c = cc * 128 + n2 * 8 + 2 * t;
    const float s0 = a.out_scale[c], s1 = a.out_scale[c + 1], z0 = a.out_zp[c], z1 = a.out_zp[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float o0 = acc[n2][2 * h], o1 = acc[n2][2 * h + 1];
      if (NORM) {
        o0 = o0 * sv;
        o1 = o1 * sv;
      } else {
        const float den = h ? den1 : den0;
        o0 = o0 / den * sv;
        o1 = o1 / den * sv;
      }
      char2 o;
      o.x = quant_i8(o0, s0, z0, a.n_out);
      o.y = quant_i8(o1, s1, z1, a.n_out);
      *reinterpret_cast<char2*>(a.out + img + (long long)(q0 + rt * 16 + g + 8 * h) * C + c) = o;
    }
  }
}

template <int C, typename VT, bool NORM>
static cudaError_t launch_core_c(const CoreArgs& a, int B, cudaStream_t s) {
  const size_t smem = (size_t)(IA_BQ + IA_TK) * (C + 16) + (size_t)C * IA_VS * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(int8_attn_core_kernel<C, VT, NORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int8_attn_core_kernel<C, VT, NORM><<<dim3(a.L / IA_BQ, B), C, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename VT, bool NORM>
static cudaError_t launch_core(const CoreArgs& a, int B, int C, cudaStream_t s) {
  if (a.L % IA_BQ != 0 || a.bk % IA_TK != 0 || a.L % a.bk != 0) return cudaErrorInvalidValue;
  if (C == 128) return launch_core_c<128, VT, NORM>(a, B, s);
  if (C == 256) return launch_core_c<256, VT, NORM>(a, B, s);
  if (C == 512) return launch_core_c<512, VT, NORM>(a, B, s);
  return cudaErrorInvalidValue;
}

// v = bf16(dot * inv_ws + zcbias), the PV operand of the dynamic core
__global__ void __launch_bounds__(PRE_THREADS)
dequant_bf16_kernel(const int32_t* __restrict__ x, const float* __restrict__ inv_ws, const float* __restrict__ zcbias,
                    __nv_bfloat16* __restrict__ out, long long n, int C) {
  for (long long i = (long long)blockIdx.x * PRE_THREADS + threadIdx.x; i < n; i += (long long)gridDim.x * PRE_THREADS)
    out[i] = __float2bfloat16_rn(proj_value(x, i, inv_ws, zcbias, (int)(i % C)));
}

// K9 (bk == L) and K10 (bk < L): int8 q, k, v and the scalars (sq, sk, sv)
extern "C" int adm_int8_attention_static(const void* q8, const void* k8, const void* v8, const void* sc,
                                         const void* out_scale, const void* out_zp, int n_out, void* out, int B,
                                         int L, int C, int bk, int online, float scale, void* stream) {
  CoreArgs a = {static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v8, static_cast<const float*>(sc),
                nullptr, static_cast<const float*>(out_scale), static_cast<const float*>(out_zp),
                static_cast<int8_t*>(out), L, bk, n_out, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (online) return (int)launch_core<int8_t, false>(a, B, C, s);
  if (bk != L) return (int)cudaErrorInvalidValue;
  return (int)launch_core<int8_t, true>(a, B, C, s);
}

// K8: int32 q / k / v accumulators with their (inv_ws, zcbias); scratch amax
// [B, 2] (zeroed), q8 / k8 int8 and vb bf16, all [B, L, C]
extern "C" int adm_fused_int8_attention(const void* dq, const void* dk, const void* dv, const void* iw_q,
                                        const void* zc_q, const void* iw_k, const void* zc_k, const void* iw_v,
                                        const void* zc_v, const void* out_scale, const void* out_zp, int n_out,
                                        void* amax, void* q8, void* k8, void* vb, void* out, int B, int L, int C,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = launch_dyn_quant_qk(static_cast<const int32_t*>(dq), f(iw_q), f(zc_q),
                                        static_cast<const int32_t*>(dk), f(iw_k), f(zc_k),
                                        static_cast<unsigned*>(amax), static_cast<int8_t*>(q8),
                                        static_cast<int8_t*>(k8), B, L, C, s);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * L * C;
  const int nb = (int)((n + PRE_THREADS * 8 - 1) / (PRE_THREADS * 8));
  dequant_bf16_kernel<<<nb < 4096 ? nb : 4096, PRE_THREADS, 0, s>>>(static_cast<const int32_t*>(dv), f(iw_v), f(zc_v),
                                                                   static_cast<__nv_bfloat16*>(vb), n, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CoreArgs a = {static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), vb, nullptr,
                static_cast<const unsigned*>(amax), f(out_scale), f(out_zp), static_cast<int8_t*>(out), L, L, n_out,
                scale};
  return (int)launch_core<__nv_bfloat16, true>(a, B, C, s);
}
