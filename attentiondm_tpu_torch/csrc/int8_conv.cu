// K1: int8 implicit-GEMM convolution, the port's conv core.
//
// Replaces the TPU kernel attentiondm_tpu/ops/pallas_conv.py
// int8_conv3_pallas (and, by its modes, the math of ops/quant_conv.py
// _conv3x3_int8_dot and int8_matmul).  On the TPU one program held a
// batch block's whole halo tile in VMEM and ran the 9 taps as MXU dots; here
// the taps are TMA box loads from device memory into a shared-memory ring
// that feeds wgmma (igemm.cuh: what bounds it and the design), and the
// dequant epilogue is fused so that the bf16 mode never writes the int32
// accumulator.
//
// Modes: ksize 3 stride 1, ksize 3 stride 2 (downsample), ksize 1; out
// int32 (mode 0), bf16 of acc * inv_ws + zcbias computed in f32 and rounded
// once (mode 1), or that sum added to a residual `res` of the output's shape:
// bf16 in and out, rounded once (mode 3), or f32 in and out, not rounded
// (mode 4).  Modes 3 and 4 are the last launch of K12 and of K3 at a bf16 or
// f32 residual stream; this entry point runs them alone for their checks.
// The caller applies the quantized-zero halo, pads Cp and Np to
// multiples of 128, hands the weights K-major (gqt [Np, ksize*ksize*Cp]) and
// the M tiling (bm, cols, rows, imgs: ops/pallas_conv.conv_tiles).
#include "igemm.cuh"

using namespace adm;

template <int KS>
static cudaError_t dispatch_mode(const IgemmArgs& a, int mode, cudaStream_t s) {
  if (mode == 0) return launch_igemm<KS, EPI_I32>(a, s);
  if (mode == 1) return launch_igemm<KS, EPI_BF16>(a, s);
  if (mode == 3) return launch_igemm<KS, EPI_RESADD_BF16>(a, s);
  if (mode == 4) return launch_igemm<KS, EPI_RESADD_F32>(a, s);
  return cudaErrorInvalidValue;
}

extern "C" int adm_int8_conv(const void* xp, const void* gqt, const void* inv_ws, const void* zcbias,
                             const void* res, void* out, int B, int Hp, int Wp, int Cp, int Ho, int Wo, int Np,
                             int ksize, int stride, int mode, int bm, int cols, int rows, int imgs,
                             void* stream) {
  IgemmArgs a;
  a.x = static_cast<const int8_t*>(xp);
  a.wt = static_cast<const int8_t*>(gqt);
  a.inv_ws = static_cast<const float*>(inv_ws);
  a.zcbias = static_cast<const float*>(zcbias);
  a.res = res;
  a.out = out;
  a.B = B; a.Hp = Hp; a.Wp = Wp; a.Cp = Cp; a.Ho = Ho; a.Wo = Wo; a.Np = Np; a.stride = stride;
  a.tile = IgemmTile{bm, cols, rows, imgs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((mode == 3 || mode == 4) != (res != nullptr)) return (int)cudaErrorInvalidValue;
  if (ksize == 3) err = dispatch_mode<3>(a, mode, s);
  else if (ksize == 1) err = dispatch_mode<1>(a, mode, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
