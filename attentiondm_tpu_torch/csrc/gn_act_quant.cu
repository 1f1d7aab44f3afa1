// K4: GroupNorm(32, eps 1e-6) -> swish or none -> n_out per-channel
// asymmetric int8 quantizations of the same normalized tensor: the entry of
// every serving resblock and of conv_out (`entry_pallas`).
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py gn_act_quant
// (_gn_quant_kernel), which held a block of whole images in VMEM and read x
// once.  A 32*32*128 bf16 image is 256 KB, over a Hopper block's 227 KB of
// shared memory, so, like K2, this kernel keeps only the statistics on
// chip: one block per image, a first pass for the per-channel f32 sums and
// sums of squares (the fixed windowed order of common.cuh; var = E[x^2] -
// mu^2 clamped at 0, as _gn_normalize), a second pass that normalizes,
// applies the activation and writes the n_out int8 outputs.  The pass is
// gn_act_quant_image in common.cuh, shared with K2, K3's first launch and
// K12.
// What bounds it on the H100: device-memory bytes, 2 B (bf16) or 4 B in and
// n_out B out per element; the second read mostly hits the 50 MB L2.  One
// block per image leaves most SMs idle at batch 32; scalar loads.  Several
// blocks per image and vector loads are later work.
#include "common.cuh"

using namespace adm;

// s_i, z_i: [N] f32 scale and zero point of output i < n_out; out_i its int8 tensor
extern "C" int adm_gn_act_quant(const void* x, int x_is_f32, const void* gn_scale, const void* gn_bias,
                                const void* s0, const void* z0, const void* s1, const void* z1,
                                const void* s2, const void* z2, int n_out, int n0, int n1, int n2,
                                void* out0, void* out1, void* out2, int swish, int B, int HW, int N,
                                int groups, float inv_count, void* stream) {
  if (n_out < 1 || n_out > 3) return (int)cudaErrorInvalidValue;
  GnQuantArgs a = {};
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  const void* ss[3] = {s0, s1, s2};
  const void* zs[3] = {z0, z1, z2};
  void* outs[3] = {out0, out1, out2};
  const int ns[3] = {n0, n1, n2};
  for (int i = 0; i < n_out; ++i) {
    a.scale[i] = static_cast<const float*>(ss[i]);
    a.zp[i] = static_cast<const float*>(zs[i]);
    a.out[i] = static_cast<int8_t*>(outs[i]);
    a.n_levels[i] = ns[i];
  }
  a.n_out = n_out; a.swish = swish; a.HW = HW; a.N = N; a.G = groups; a.inv_count = inv_count; a.halo_w = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32) return (int)launch_gn_act_quant(static_cast<const float*>(x), a, B, s);
  return (int)launch_gn_act_quant(static_cast<const __nv_bfloat16*>(x), a, B, s);
}
