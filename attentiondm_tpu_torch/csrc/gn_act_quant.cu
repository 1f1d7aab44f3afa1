// K4: GroupNorm(32, eps) -> swish or none -> n_out per-channel
// asymmetric int8 quantizations of the same normalized tensor: the entry of
// every serving resblock and of conv_out, and the composed attention block's
// three-output entry, wherever a form below takes the shape.
//
// Replaces the TPU kernel attentiondm_tpu/ops/fused_gn.py gn_act_quant
// (_gn_quant_kernel), which held a block of whole images in VMEM and read x
// once.  A 32*32*128 bf16 image is 256 KB, over a Hopper block's 227 KB of
// shared memory, and one block per image leaves most of the 132 SMs idle at
// batch 32, so K4 runs on the GroupNorm kernels of gn_epilogue.cuh with x
// as the producer (no epilogue) and 1 to 3 int8 outputs as the consumer, in
// the form ops/fused_gn.epilogue_plan(..., "K4") picks:
//   images of up to 32 windows (1024 rows): the image form, one block per
//   image or per slice of whole groups, no cluster and no bulk copy; up to
//   2048 channels (imagenet64's 1536- and 2048-channel decoder entries),
//   sliced so that a block stays within the launch bound;
//   larger images on the 128-channel grid (up to 1024 channels, at most 132
//   chunks of 1024 rows an image: church's 64^2 to 256^2 entries): the
//   blocked form (gn_entry_blocked_kernel), one cooperative launch of
//   resident blocks over (image, chunk) items in image-major order, as K6.
//   Each item publishes its chunk's channel sums, the image's last arrival
//   adds them in window_sum's order and publishes mean and rstd, and each
//   item applies its chunk, re-read through L2.  A cluster of 4 blocks an
//   image (the cluster form's plan at batch 32) is a quarter of a wave of
//   threads with 8 to 16 MB a block to stream twice; the grid keeps every
//   SM busy;
//   larger images off that grid: the cluster form, a thread-block cluster
//   per image whose blocks own whole 32-row windows and add each other's
//   window sums through distributed shared memory.
// The f32 sums keep the fixed windowed order of common.cuh (var = E[x^2] -
// mu^2 clamped at 0, as _gn_normalize), so K4 equals its plain version to
// the bit in every form.  Its bound is the bytes: 2 B (bf16) or 4 B in and
// n_out B out per element, read once; what holds it back on the H100 is the
// apply pass's f32 work, as K2 (gn_epilogue.cuh), and in the blocked form
// the second read of each chunk, from L2 where the image's chunks in flight
// fit it.  The same launcher runs K3's first launch (int8_attention.cu) and
// K12's first (resblock.cu), in the image and cluster forms.
#include "gn_epilogue.cuh"

using namespace adm;

template <int NOUT>
static cudaError_t launch_form(const EpiArgs& a, int x_is_f32, const GnPlan& p, cudaStream_t s) {
  if (p.form != 2) return launch_gn_x<NOUT, false>(a, x_is_f32, p, s);
  if (x_is_f32) return launch_gn_entry_blocked<float, NOUT>(a, p, s);
  return launch_gn_entry_blocked<__nv_bfloat16, NOUT>(a, p, s);
}

static cudaError_t launch_nout(const EpiArgs& a, int n_out, int x_is_f32, const GnPlan& p, cudaStream_t s) {
  if (n_out == 1) return launch_form<1>(a, x_is_f32, p, s);
  if (n_out == 2) return launch_form<2>(a, x_is_f32, p, s);
  return launch_form<3>(a, x_is_f32, p, s);
}

// s_i, z_i: [N] f32 scale and zero point of output i < n_out; out_i its int8
// tensor; partial, flags: the blocked form's scratch (null in the other
// forms), f32 [B * nchunk * 2 * N + B * 2 * groups] and int32 [1 + 2 * B]
// zeroed; plan: ops/fused_gn.plan_args of epilogue_plan(..., "K4")
extern "C" int adm_gn_act_quant(const void* x, int x_is_f32, const void* gn_scale, const void* gn_bias,
                                const void* s0, const void* z0, const void* s1, const void* z1,
                                const void* s2, const void* z2, int n_out, int n0, int n1, int n2,
                                void* out0, void* out1, void* out2, int swish, int B, int HW, int N,
                                int groups, float inv_count, float eps, void* partial, void* flags, const int* plan,
                                void* stream) {
  if (n_out < 1 || n_out > 3) return (int)cudaErrorInvalidValue;
  EpiArgs a = {};
  a.x = x;
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  const void* ss[3] = {s0, s1, s2};
  const void* zs[3] = {z0, z1, z2};
  void* outs[3] = {out0, out1, out2};
  const int ns[3] = {n0, n1, n2};
  for (int i = 0; i < n_out; ++i) {
    a.act_scale[i] = static_cast<const float*>(ss[i]);
    a.act_zp[i] = static_cast<const float*>(zs[i]);
    a.out[i] = static_cast<int8_t*>(outs[i]);
    a.n_levels[i] = ns[i];
  }
  a.partial = static_cast<float*>(partial);
  a.flags = static_cast<int*>(flags);
  a.B = B; a.HW = HW; a.N = N; a.G = groups; a.swish = swish; a.inv_count = inv_count; a.eps = eps;
  const GnPlan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  return (int)launch_nout(a, n_out, x_is_f32, p, static_cast<cudaStream_t>(stream));
}
