// K1: int8 implicit-GEMM convolution, the port's conv core.
//
// Replaces the TPU kernel attentiondm_tpu/ops/pallas_conv.py
// int8_conv3_pallas (and, by its modes, the math of ops/quant_conv.py
// _conv3x3_int8_dot and int8_matmul).  On the TPU one program held a
// batch block's whole halo tile in VMEM and ran the 9 taps as MXU dots; here
// the taps are read straight from device memory per 128 x 128 output tile
// (igemm.cuh), and the dequant epilogue is fused so that the bf16 mode
// never writes the int32 accumulator.
//
// Modes: ksize 3 stride 1, ksize 3 stride 2 (downsample), ksize 1; out
// int32 (mode 0) or bf16 of acc * inv_ws + zcbias computed in f32 and rounded
// once (mode 1).  The caller applies the quantized-zero halo and pads Cp and
// Np to multiples of 128.
#include "igemm.cuh"

using namespace adm;

template <int KS>
static cudaError_t dispatch_mode(const IgemmArgs& a, int mode, cudaStream_t s) {
  if (mode == 0) return launch_igemm<KS, EPI_I32>(a, s);
  if (mode == 1) return launch_igemm<KS, EPI_BF16>(a, s);
  return cudaErrorInvalidValue;
}

extern "C" int adm_int8_conv(const void* xp, const void* gq, const void* inv_ws, const void* zcbias,
                             void* out, int B, int Hp, int Wp, int Cp, int Ho, int Wo, int Np,
                             int ksize, int stride, int mode, void* stream) {
  if (Cp % IG_BK != 0 || Np % IG_BN != 0) return (int)cudaErrorInvalidValue;
  IgemmArgs a;
  a.x = static_cast<const int8_t*>(xp);
  a.w = static_cast<const int8_t*>(gq);
  a.inv_ws = static_cast<const float*>(inv_ws);
  a.zcbias = static_cast<const float*>(zcbias);
  a.res = nullptr;
  a.out = out;
  a.B = B; a.Hp = Hp; a.Wp = Wp; a.Cp = Cp; a.Ho = Ho; a.Wo = Wo; a.Np = Np; a.stride = stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ksize == 3) err = dispatch_mode<3>(a, mode, s);
  else if (ksize == 1) err = dispatch_mode<1>(a, mode, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
