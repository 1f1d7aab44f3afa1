#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`attentiondm_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--steps 10] [--seed 0] [--profile]
                          [--paths cifar10,church,celeba-wide,imagenet64,cifar10-enhanced,cifar10-f32,cifar10-cli,
                                   cifar10-train,cifar10-quality]

(`--profile` adds, after the last phase, torch.profiler's device time per
kernel for one run of each sampler and one training step; `--paths` runs only the paths named,
all nine by default.)

1. header: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the CUDA kernels from attentiondm_tpu_torch/csrc/;
3. then the CIFAR-10 W4A8 sampler (`UNetConfig()`, batch 128) and the LSUN
   church W4A8 sampler (`configs/church.yml`, 256^2, batch 32, at most 4
   steps), both with the f32 attention core (`attn_int8=False`):
   a. kernels: each kernel against its plain PyTorch version on the card at
      every distinct shape the path's serving step gives it
      (`ops.checks.conv_plan`), held to its tolerance (`ops.checks.compare`),
      with times (CUDA events, median of 20 launches, 10 for the plain
      version): K1 at every int8 conv shape (its int32 mode at the 3x3
      shapes is K13's check, its 1x1 mode at the shortcut shapes K5's), K2
      and K6 at every resblock epilogue shape as the router sends them
      (`epilogue_phase`: bit-equal to the plain version, the launch plan and
      the share of the bound printed; at K6's shapes K2 is also run and
      timed against K6; one int32-input check a kernel), K3 at every
      attention shape.  K4, K7 and K12 at every shape a serving step launches
      under the three levers together or one alone (`ops.checks.lever_plan`);
      K4, K7 and K12 bit-equal to their plain versions, with their GroupNorm
      launch plans (`ops.fused_gn.epilogue_plan(..., "K4")`, `"K7"`; K7 on
      the serving path's inputs: bf16 conv2 output and residual).
      A kernel's `ms` / `device_ms` / `plain_ms` / `bound_ms` in the JSON
      line is the sum over one serving step's launches of it (the step with
      all three levers for K4, K7 and K12).  `ms` includes the Python
      wrapper; `device_ms` leaves its host time out: CUDA events around
      20 calls queued behind a busy card, which then runs them back to back.
      `bound_ms` is the least time the card could take: per launch the
      larger of its bytes (every input read once, every output written
      once) over 3.35 TB/s and its operations over the
      peak of their type (1,979 TOP/s int8 and 989 TFLOP/s bf16 on the tensor
      cores, 495 / 3 TFLOP/s for f32 products run there as 3xTF32, 67
      TFLOP/s f32 outside them); `library_ms` times the one PyTorch call that
      computes the same function, where there is one (`torch._int_mm` for
      K5, `F.scaled_dot_product_attention` for K3's core alone), and is null
      elsewhere.  `K3.core` is K3's f32 core timed alone through its own C
      entry point (`ops.int8_attention.attention_core`) on f32 q, k, v at K3's
      shapes; its launches are the path's K3 launches, each of which runs
      that kernel once;
   b. slice: the full-width UNet at W4A8 with seeded random weights: FP DDIM
      teacher trajectory on 2 images, stage-1 calibration, the per-step fold
      and the int8 serving DDIM sampler (--steps quad steps; --steps 100 is
      bench.py's schedule).  Checks the output's shape and finiteness and
      each kernel's launch count against `ops.checks.expected_launches`;
      then one serving step teacher-forced, every kernel call held to its
      tolerance against its plain version on the same inputs
      (`ops.checks.per_site`), and the whole step through the kernels
      against the whole step through the plain versions (printed, held to a
      gross-fault bound);
   c. levers: the same params, calibration and fold with `entry_pallas`,
      `boundary_fusion` and `resblock_pallas="all"`.  CIFAR-10: the sampler
      again with all three (launch counts of K4, K7, K12 and the changed
      K1 / K2 counts against `expected_launches`), the per-site step and the
      chained step under the levers, and timed runs in turns of levers off,
      all three, and each lever alone (the median of each is printed).  Church: one per-site step with the
      three levers, launch counts checked;
   d. weights (CIFAR-10): the W4 weight-quality pass on the same params,
      calibration and input, on the card (`weights_phase`): the Gram
      collection, AdaRound (1000 Adam steps), GPTQ and bias correction, timed,
      with the Gram objectives of the offsets against round-to-nearest's
      (each sum must be below it); `refine_weight_extras` shared and per step
      (never worse than its init); every set of extras folded and served
      through the kernels with the levers off and all three on (launch
      counts, every site of a step, finite output; the per-step refined
      extras chunked bit-equal to the unchunked sampler); the surrogate's
      convs against the served fold's on the same inputs (< 1e-4) and its
      whole step against the serving step; the fake-quant model's sample, and
      how far each served sample lies from it and from the FP teacher's;
   e. stage2 (CIFAR-10): on the same params, trajectory, teacher eps and GPTQ
      extras, three stage-2 calibrations, timed (`stage2_phase`):
      `calibrate_differentiable(attention_focus=True)` (1 epoch),
      `calibrate_teacher_matched` on the `prepare_params` weights and through
      the serving surrogate with the GPTQ extras (each run's best objective at
      or below its stage-1 init at every step); each folded and served through
      the kernels (launch counts, every site of a step, finite output) and
      its sample's distance from the FP teacher's printed.
4. celeba-wide: CelebA's UNet (`configs/celeba.yml`: 64^2, ch 128, ch_mult
   1-2-2-2-4, batch 64) at full width and depth with `attn_resolutions` set
   to (64, 32, 16), so that it attends at L = 4096 (C = 128), 1024 (C = 256),
   256 (C = 256) and 16 (C = 512), the one model that reaches every attention
   kernel:
   a. kernels: K10, K9, K8, K11 and K3 with its int8 core against their plain
      versions at every shape a serving step gives them under the three
      attention settings (`ops.checks.attention_plan`), timed as above, and
      K2 at every epilogue shape as in 3a; K11
      also beside `F.scaled_dot_product_attention`, the library call for its
      function (`library_ms`; K8, K9 and K10 have none: no PyTorch call takes
      int8 q and k and returns an int8 requantized output);
   b. slice: FP teacher on 2 images (K11 at 10 sites a forward), stage-1
      calibration with the attention ranges, the fold, then the serving
      sampler under each setting: `attn_int8=True` with `attn_ranges` (K10,
      K9 and K3's int8 core), `attn_int8=True` without (K8 at the 64^2 and
      32^2 sites, K3's int8 core) and `attn_int8=False` (K11
      and K3's f32 core); launch counts, shape and finiteness, the per-site
      step and the chained step for each, and (information only) how far the
      two int8-core samples lie from the f32-core sample.
5. imagenet64: `configs/imagenet64.yml` (64^2, ch 128, ch_mult 1-2-4-8, 3
   res blocks, attention at 16^2, the cosine schedule), batch 32, full depth,
   at most 4 steps, the f32 attention core (bench.py's flags), as 3a to 3c
   (K3 also at (64, 1024) with the int8 core, checked, not counted: the path
   runs the f32 core; K4 at the 1536- and 2048-channel entries of the lever
   step), then
   d. folds: the same sampler with `step_chunk=2, micro_batch=16`, with
      `pack_int4=True` and with both, each held bit-equal to the unchunked,
      unpacked output (launch counts checked), and with `rank1=True`, held by
      the per-site and chained step on its fold; each fold's size.
6. cifar10-enhanced: CIFAR-10's UNet with the enhanced attention variant
   (`UNetConfig(attn_variant="enhanced")`: at 16^2, C = 256, Ck = 32, 8
   heads; gamma seeded nonzero, as JAX's init of 0 makes every block the
   identity), batch 128, `--steps` quad steps, the runner's
   `--attn_variant enhanced --calibrate_attention
   --mixed_precision_attention` flow:
   a. kernels as 3a: K1 at every int8 conv shape of the step, the four 1x1
      projection shapes among them (K5), K2 at the epilogue shapes, K4 / K7 /
      K12 at the lever shapes; no attention kernel (the core is plain torch);
   b. slice (`enhanced_slice_phase`): FP teacher on 16 images, stage 1, the
      calibration set by t-mode "diff", `calibrate_differentiable
      (attention_focus=True)`, stage 3 (`make_logit_collector` +
      `calibrate_mp_attention` at timesteps 0 / 250 / 500 / 750 / 999), the
      fold, then the sampler with the stage-3 core at base bits 4 (W4A8's
      --bitwidth) and without it: launch counts, the sampler's wall and device
      time, the per-site and chained step each; how far the MP sample lies
      from the plain one (it must differ) and from the fake-quant MP model's;
   c. levers: one per-site step of the MP sampler with the three levers,
      launch-counted.
7. cifar10-f32: CIFAR-10's UNet at JAX's default float32 residual stream,
   batch 128, --steps quad steps, the f32 attention core:
   a. kernels (`f32_kernel_phase`): K3 at an f32 residual (K3's tolerance
      restated for an f32 output, `ops.checks.compare`; also church's (32,
      256, 512) and imagenet64's (32, 64, 1024), checked, not counted), K12
      at f32, K1's f32 residual-add epilogue (EPI_RESADD_F32, K3's and K12's
      last launch) alone, K4 on the f32 stream and K7 with an f32 residual
      and output (each bit-equal), K2 on the int32 accumulator
      (dot_bf16=False), K13 / K5 at every conv of the interception
      runtime's step;
   b. slice: teacher, stage 1, the fold, the f32-stream sampler (levers
      off), counted and checked as 3b;
   c. f32 (`f32_phase`): the sampler with the three levers, with
      dot_bf16=False, with conv_pallas=True (held bit-equal to the levers-off
      sample), each counted and checked site by site; then the device time
      of one run of the bf16 and f32 samplers (levers off, all three) and of
      dot_bf16=False, each replayed as a CUDA graph in this one call;
   d. interception (`interception_phase`): `prepare_int8_runtime` with
      symmetric and asymmetric folds, each as an `int8_model_fn` DDIM
      sampler (launch counts against `ops.checks.interception_launches`),
      one step held site by site and chained against the plain step, its
      device time; one `QuantizedUNet.apply(mode="int8")` forward, counted
      and held site by site.
8. cifar10-cli: the CLI, `main_torch.main(argv)` in this process, at
   cifar10.yml (ch 128, ch_mult 1-2-2-2, attention at 16^2), --batch_size
   128 --num_samples 128 --timesteps --steps --skip_type quad --ni, the exp
   tree under exp/chip_smoke_cli (`cli_phase`): (a) --execution serving with
   --ckpt_path to a reference-named torch state dict written from the seeded
   generator (the loaded params held equal to it) and --calib_cache auto
   (the runner's default weight pass, GPTQ with the per-step refinement);
   (b) --sample_type ddpm_noisy and (c) --eta 0.5 --weight_refine off (the
   cut: (c) calibrates anew, its eta being in the cache's header); each
   serving run's launches against `expected_launches`, one served step site
   by site and chained, its PNGs equal to the sampler's images, and the run
   against its plain run on the same generator (< 0.1); (d) --fid
   --num_samples 256, ids 130 and up deleted and the run resumed: every
   file byte-identical, PNGs read back with zlib equal to the uint8 images;
   (e) --execution fake_quant, --fp32, --fp32 --compute_dtype bfloat16.
   Each run prints its seconds per stage (load, teacher, calibration,
   weight pass, refinement, fold, sampling, png) and its images/s.  The
   path adds no row to the kernels line (its kernels are CIFAR-10's K1, K2
   and K3, measured by the paths above).
9. cifar10-train: the training half through the CLI at cifar10.yml's full
   width (ch 128, ch_mult 1-2-2-2, attention at 16^2, dropout 0.1, Adam 2e-4,
   clip 1.0, EMA 0.9999), batch 512, on a seeded stand-in for CIFAR-10:
   10240 training and 1024 test images made by `synthetic_batch` on the card
   and written as uint8 in CIFAR-10's pickle layout under
   exp/chip_smoke_train/datasets (`train_phase`; the cuts, printed: n_iters
   30, snapshot_freq 10, the image count):
   a. one step at full width on 4 images on the card against the same step
      on the CPU, given the same params, batch, t, eps and dropout masks: the
      loss and the gradient norm before clipping within 1e-5 relative, the
      params, Adam's moments and the EMA by `training.compare_train_states`;
   b. `main_torch.main` trains 30 steps: every loss finite, the last 10
      steps' mean below the first 10's, ckpt_1 / 10 / 20 / 30, ckpt.npz,
      train_metrics.csv and the event file; no kernel launched; the step's
      median wall, device time by part (CUDA events: forward + backward,
      optimizer, EMA), images/s, peak memory and its bound (the convolution
      and attention FLOPs over 67 TFLOP/s);
   c. --resume_training to 40 steps: the state loaded equal to ckpt.npz,
      the steps logged 31..40;
   d. --test --fp32 on the EMA and (model.ema false) on the params, which
      must test lower; then --test --execution serving (the served step's
      launches against `expected_launches`): the eps-MSE and its coverage;
   e. --sample --execution serving --fid --num_samples 128 on the trained
      EMA (ckpt.npz's, as cifar10.yml's model.ema says; (d)'s calibration
      cache), then on the trained params (model.ema false, calibrated anew):
      launches, one step site by site and chained, the served sample's
      distance from the fp sample of the same weights;
   f. tools/train_synthetic.py: 20 steps of each distribution at batch 128,
      the EMA loaded through --ckpt_path, --resume from .train.npz.
   The path adds no row to the kernels line (the training step reaches no
   kernel; its served runs reach K1, K13, K5, K2 and K3, measured above).
10. cifar10-quality: the eval and quality slice at CIFAR-10's full width
   (`UNetConfig()`, 35.75M params), its tree under exp/chip_smoke_quality
   (`quality_phase`):
   a. eval: the seeded random FID Inception (`eval/inception.py`) on the card
      under `exact_f32()` against the same network on the CPU (8 images at
      32^2, max rel err < 1e-4); the features of 1024 images at batch 256
      timed by CUDA events (images/s, peak memory, the share of the
      convolutions' f32 bound, counted by `FlopCounterMode`);
      `eval/fid.sharded_statistics` (JAX's float32 sums of f and f f^T) against
      float64 mean and `np.cov` over the same features (the error printed);
   b. ladder: `tools/train_synthetic` trains the UNet 60 steps at batch 128
      (cut from 12000), then `tools/quality_protocol.run_protocol` on its EMA
      at --steps quad steps, batch 64, calibration batch 8, bits 8:8 and 4:8,
      stage 2, the bf16 row, KID, the serving rows and `--adaround
      --weight_rows gptq`: the table as `[quality]` lines; every row finite,
      fp32 0, w8a8_s1 at or below w4a8_s1; each serving row (its sampler and
      its eps scan) launching what `expected_launches` says, the others none;
   c. fid: `eval.fid --save-stats` over 512 stand-in PNGs written by
      `utils/images`, then `main_torch.main(--sample --fid --fid_stats
      --execution serving)` on the trained EMA, 256 images at batch 128,
      without --inception_weights: the launches, the folder scored after the
      run, the FID printed and returned equal to the API's that JAX's runner
      scores with (`sharded_statistics` + `frechet_smoke_safe`) to 1e-6 and
      within 1e-4 of the float64 route (`compute_statistics_of_path`);
   d. on-ramp and bench: `tools/real_ckpt` on stand-in assets in a temp dir
      (a `TorchDDIMUNet` toy's state dict, a randomized `TorchFIDInception`,
      reference statistics): the golden check (< 5e-4), a finite sample, the
      statistics saved; `tools/train_bench --batches 512 --steps 5`.
   The path adds no row to the kernels line: its serving runs reach K1, K13,
   K5, K2 and K3 (measured above); the Inception, the statistics and the
   training step run in cuDNN / cuBLAS.
Prints a JSON line of per-kernel results, then {"ok": true, "device": ...}
as the last line.  Any failure raises (nonzero exit, no result line); so
does a machine without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

CHAINED_BOUND = 0.1  # whole step, kernels vs plain versions: mean relative error (gross faults only)
BATCH = {"cifar10": 128, "church": 32, "celeba-wide": 64, "imagenet64": 32, "cifar10-enhanced": 128,
         "cifar10-f32": 128, "cifar10-cli": 128, "cifar10-train": 512, "cifar10-quality": 64}
MAX_STEPS = {"church": 4, "imagenet64": 4}  # a shallower schedule where the path is long
LEVER_ROUNDS = 3  # timed runs per lever setting, taken in turns
F32_CORE = dict(attn_int8=False)  # the attention flag of the CIFAR-10 and church paths (bench.py's)
# the three attention settings of the celeba-wide path; attn_ranges=True stands for the calibrated ranges
ATTN_SETTINGS = {"static int8": dict(attn_int8=True, attn_ranges=True), "dynamic int8": dict(attn_int8=True),
                 "f32 core": F32_CORE}

META = {  # kernel -> (wrapper, source, the TPU kernel it replaces)
    "K1": ("int8_conv (implicit-GEMM int8 conv, all modes)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
           "attentiondm_tpu/ops/pallas_conv.py:97"),
    "K13": ("int8_conv int32 3x3 mode (_conv3x3_int8_dot)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
            "attentiondm_tpu/ops/quant_conv.py:116"),
    "K5": ("int8_conv 1x1 mode (int8_matmul)", "attentiondm_tpu_torch/csrc/int8_conv.cu",
           "attentiondm_tpu/ops/quant_conv.py:57"),
    "K2": ("epilogue_gn_swish_quant_whole", "attentiondm_tpu_torch/csrc/fused_gn.cu",
           "attentiondm_tpu/ops/fused_gn.py:188"),
    "K6": ("epilogue_gn_swish_quant_blocked", "attentiondm_tpu_torch/csrc/fused_gn_blocked.cu",
           "attentiondm_tpu/ops/fused_gn.py:432"),
    "K3": ("fused_attention_block", "attentiondm_tpu_torch/csrc/int8_attention.cu",
           "attentiondm_tpu/ops/int8_attention.py:448"),
    "K4": ("gn_act_quant", "attentiondm_tpu_torch/csrc/gn_act_quant.cu", "attentiondm_tpu/ops/fused_gn.py:109"),
    "K7": ("epilogue_residual_gn_stats", "attentiondm_tpu_torch/csrc/epilogue_residual_gn_stats.cu",
           "attentiondm_tpu/ops/fused_gn.py:292"),
    "K12": ("resblock_pallas", "attentiondm_tpu_torch/csrc/resblock.cu",
            "attentiondm_tpu/ops/pallas_resblock.py:114"),
    "K8": ("fused_int8_attention", "attentiondm_tpu_torch/csrc/int8_attn_core.cu",
           "attentiondm_tpu/ops/int8_attention.py:73"),
    "K9": ("fused_int8_attention_static", "attentiondm_tpu_torch/csrc/int8_attn_core.cu",
           "attentiondm_tpu/ops/int8_attention.py:159"),
    "K10": ("int8_flash_attention_static", "attentiondm_tpu_torch/csrc/int8_attn_core.cu",
            "attentiondm_tpu/ops/int8_attention.py:270"),
    "K11": ("flash_attention", "attentiondm_tpu_torch/csrc/flash_attention.cu", "attentiondm_tpu/ops/attention.py:53"),
    "K3.int8_core": ("fused_attention_block(int8_core=True)", "attentiondm_tpu_torch/csrc/int8_attention.cu",
                     "attentiondm_tpu/ops/int8_attention.py:448"),
    # the core kernel of K3's chain alone; each K3 launch on the path runs it once
    "K3.core": ("attention_core (K3's f32 core alone)", "attentiondm_tpu_torch/csrc/int8_attention.cu",
                "attentiondm_tpu/ops/int8_attention.py:448"),
    # the cifar10-f32 path: the float32 residual stream, dot_bf16=False
    "K3.f32": ("fused_attention_block, f32 residual", "attentiondm_tpu_torch/csrc/int8_attention.cu",
               "attentiondm_tpu/ops/int8_attention.py:448"),
    "K12.f32": ("resblock_pallas, f32 residual", "attentiondm_tpu_torch/csrc/resblock.cu",
                "attentiondm_tpu/ops/pallas_resblock.py:114"),
    "K1.resadd_f32": ("int8_conv f32 residual-add mode (EPI_RESADD_F32; K3's and K12's last launch)",
                      "attentiondm_tpu_torch/csrc/igemm.cuh", "attentiondm_tpu/ops/pallas_conv.py:97"),
    "K4.f32": ("gn_act_quant, f32 residual", "attentiondm_tpu_torch/csrc/gn_act_quant.cu",
               "attentiondm_tpu/ops/fused_gn.py:109"),
    "K7.f32": ("epilogue_residual_gn_stats, f32 residual and out",
               "attentiondm_tpu_torch/csrc/epilogue_residual_gn_stats.cu", "attentiondm_tpu/ops/fused_gn.py:292"),
    "K2.int32": ("epilogue_gn_swish_quant_whole, int32 accumulator (dot_bf16=False)",
                 "attentiondm_tpu_torch/csrc/fused_gn.cu", "attentiondm_tpu/ops/fused_gn.py:188"),
}
# which sampler run of the celeba-wide path a kernel's launch count is read from
ATTN_RUN = {"K10": "static int8", "K9": "static int8", "K3.int8_core": "static int8", "K8": "dynamic int8",
            "K11": "f32 core"}
ALL_LEVERS = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
LEVER_SETS = {"all three": ALL_LEVERS, "entry_pallas": dict(entry_pallas=True),
              "boundary_fusion": dict(boundary_fusion=True), "resblock_pallas=all": dict(resblock_pallas="all")}

# the card's published peaks (H100 SXM data sheet), for `bound_ms`
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12  # tensor cores, dense
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
# f32 products on the tensor cores as 3xTF32 (K3's core): three TF32 products (495 TFLOP/s dense) for each.
# One TF32 pass would be faster but rounds each operand to 10 bits, which K3's tolerance does not allow
# (1.3% of proj_out's input codes flip), so the split is the least work that computes the function.
TF32X3_FLOPS_PER_S = 495e12 / 3


def bound(nbytes, int8_ops=0, f32_flops=0, bf16_flops=0, tf32x3_flops=0):
    """(bytes ms, operations ms) the card needs at least for one launch."""
    ops = (int8_ops / INT8_OPS_PER_S + bf16_flops / BF16_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S
           + tf32x3_flops / TF32X3_FLOPS_PER_S)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops * 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def path_config(path):
    """(UNetConfig, DiffusionSchedule, label) of a path: CIFAR-10's default
    config, the church model loaded from the repository's church.yml, CelebA's
    from celeba.yml with attention at 64^2, 32^2 and 16^2, or ImageNet-64's
    from imagenet64.yml (its cosine schedule)."""
    import dataclasses

    from attentiondm_tpu_torch.config import load_config
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import UNetConfig

    if path == "cifar10":
        return UNetConfig(), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000), "UNetConfig() CIFAR-10"
    if path == "cifar10-quality":
        return (UNetConfig(), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000),
                "UNetConfig() CIFAR-10, trained here: eval, the quality ladder, --fid_stats, the on-ramp and bench")
    if path == "cifar10-f32":
        return (UNetConfig(), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000),
                "UNetConfig() CIFAR-10, the float32 residual stream")
    if path in ("cifar10-cli", "cifar10-train"):
        config = load_config("cifar10.yml")
        return (UNetConfig.from_config(config), DiffusionSchedule.from_config(config),
                f"cifar10.yml CIFAR-10 through main_torch.py{', trained' if path == 'cifar10-train' else ''}")
    if path == "cifar10-enhanced":
        return (UNetConfig(attn_variant="enhanced"), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000),
                "UNetConfig(attn_variant=\"enhanced\") CIFAR-10")
    if path == "celeba-wide":
        config = load_config("celeba.yml")
        cfg = dataclasses.replace(UNetConfig.from_config(config), attn_resolutions=(64, 32, 16))
        return cfg, DiffusionSchedule.from_config(config), "celeba.yml CelebA with attn_resolutions=(64, 32, 16)"
    if path == "imagenet64":
        config = load_config("imagenet64.yml")
        return UNetConfig.from_config(config), DiffusionSchedule.from_config(config), "imagenet64.yml ImageNet-64"
    config = load_config("church.yml")
    return (UNetConfig.from_config(config), DiffusionSchedule.from_config(config),
            "church.yml LSUN church_outdoor")


SPIN_CYCLES = 40_000_000  # about 20 ms of torch.cuda._sleep at the H100's clocks (`device_ms`)


def device_ms(fn, reps: int = 20) -> float:
    """Device time in ms of one call of `fn`, the wrapper's host time left
    out: CUDA events around `reps` calls that the host enqueues while the card
    still runs a spin kernel, so the card then runs them back to back.  An
    event behind the spin kernel that has not completed when the last call is
    enqueued shows that every call waited on the card; if it has, the spin is
    made four times as long and the measurement taken again.  The figure
    holds everything the wrapper launches: its own kernels and, for K3, the
    few small torch kernels that pack its vectors."""
    import torch

    fn()
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    cycles = SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not spun.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("device_ms: the host could not enqueue the calls while the card was busy")


def graph_ms(fn, reps: int = 3):
    """Device time in ms of one call of a host-bound `fn` (a whole sampler:
    its ~10,000 launches fill the card's launch queue, so `device_ms` cannot
    queue them behind a spin kernel): `fn` captured once as a CUDA graph and
    replayed `reps` times between CUDA events, so the card runs its kernels
    back to back.  A capture that fails raises: the figure is never left
    out of a passing run."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
        with torch.cuda.graph(graph, stream=stream):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def time_ms(fn, reps: int = 20, warm: bool = True) -> float:
    """Median per-call time in ms, CUDA events around each call, after a warm-up."""
    import torch

    if warm:
        fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


class Report:
    """Per-kernel error and time, summed over one serving step's launches."""

    def __init__(self):
        self.rows = {}

    def add(self, key, err, ms, plain_ms, bound_ms, weight=1, library_ms=None, dev_ms=0.0):
        r = self.rows.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                       "bound_ms": 0.0,
                                       "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += weight * ms
        r["device_ms"] += weight * dev_ms
        r["plain_ms"] += weight * plain_ms
        r["bound_ms"] += weight * max(bound_ms)
        r["bytes_ms"] += weight * bound_ms[0]
        r["ops_ms"] += weight * bound_ms[1]
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + weight * library_ms


def weights_kmajor(gq, inv_ws, zcbias):
    """K3's weight tuple as the serving path hands it: with the fold's K-major copy."""
    from attentiondm_tpu_torch.ops.pallas_conv import k_major

    return gq, inv_ws, zcbias, k_major(gq)


def _fig(f) -> str:
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in f.items())


def _bound_fig(b) -> str:
    return f"bound {max(b):.4f} ms ({'bytes' if b[0] >= b[1] else 'operations'})"


def _held(kind, label, got, want):
    from attentiondm_tpu_torch.ops import checks

    f = checks.compare(kind, got, want)
    if not f["ok"]:
        raise AssertionError(f"{kind} {label}: {f}")
    return f


def _bit_equal(kind, label, got, want):
    """`_held`, and the output (or each of a tuple of outputs) equal to the plain version's bits."""
    import torch

    f = _held(kind, label, got, want)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    if not all(torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{kind} {label}: not bit-equal to its plain version ({f})")
    return f


def epilogue_phase(cfg, batch, gen, dev, report):
    """K2 and K6 at every resblock epilogue shape of a serving step, as the
    router sends the bf16 conv1 output (identity epilogue; the first channel
    group at a large offset, mean 40, where float32 E[x^2] - mu^2 cancels):
    the launch plan, equality to the bit with the plain version, times, the
    bound and the share of it the device time reaches.  At K6's shapes K2 runs
    too, for its time.  Then one int32-input check a kernel (the conv's
    accumulator with inv_ws / zcbias) at the kernel's largest shape."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.fused_gn import (
        epilogue_gn_swish_quant,
        epilogue_gn_swish_quant_blocked,
        epilogue_gn_swish_quant_whole,
        epilogue_plan,
    )

    _k1, k2, k6, _k3, _composed = checks.conv_plan(cfg)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    def args_of(HW, N, x_dtype):
        H = int(HW ** 0.5)
        if x_dtype == torch.int32:
            dot = torch.randint(-20000, 20000, (batch, H, H, N), generator=gen, dtype=torch.int32).to(dev)
            inv_ws, zcbias = randf((N,), 2e-5, 1e-4).abs(), randf((N,))
        else:
            dot = randf((batch, H, H, N), 2.0, 0.3).to(torch.bfloat16)
            inv_ws, zcbias = torch.ones(N, device=dev), torch.zeros(N, device=dev)
        zcbias[:N // 32] += 40.0
        return (dot, inv_ws, zcbias, randf((batch, N)), randf((N,), 0.1, 1.0), randf((N,), 0.1),
                torch.full((N,), 255 / 4.5, device=dev), torch.full((N,), round(255 / 4.5 * -0.5) + 128.0, device=dev),
                8)

    def plan_fig(kind, HW, N, x_dtype):
        p = epilogue_plan(batch, HW, N, x_dtype, kind)
        if kind == "K6":
            return f"plan: {p['blocks_per_image']} chunk items an image, {p['threads']} threads, one launch"
        return (f"plan: {p['cluster']} blocks an image ({batch * p['cluster']} blocks), {p['rows']} rows a block, "
                f"{p['threads']} threads, slab {'held in shared memory' if p['held'] else 're-read from L2'}")

    for kind, shapes in (("K2", k2), ("K6", k6)):
        for (HW, N), n in sorted(collections.Counter(shapes).items()):
            args = args_of(HW, N, torch.bfloat16)
            f = _bit_equal(kind, f"HW={HW} N={N}", epilogue_gn_swish_quant(*args),
                           epilogue_gn_swish_quant(*args, plain=True))
            ms = time_ms(lambda: epilogue_gn_swish_quant(*args))
            dms = device_ms(lambda: epilogue_gn_swish_quant(*args))
            pms = time_ms(lambda: epilogue_gn_swish_quant(*args, plain=True), reps=10)
            # 18 f32 operations per element: the TPU kernel's own cost estimate
            b = bound(nbytes(*args[:8]) + args[0].numel(), f32_flops=18 * args[0].numel())
            report.add(kind, f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
            print(f"[kernels] {kind} epilogue_gn_swish_quant B={batch} HW={HW} N={N} x{n}/step: {_fig(f)}, bit-equal; "
                  f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}, device at "
                  f"{max(b) / dms:.1%} of it; {plan_fig(kind, HW, N, torch.bfloat16)}")
            if kind == "K6":
                f2 = _bit_equal("K2", f"HW={HW} N={N} (at K6's shape)", epilogue_gn_swish_quant_whole(*args),
                           epilogue_gn_swish_quant_whole(*args, plain=True))
                ms2 = time_ms(lambda: epilogue_gn_swish_quant_whole(*args))
                dms2 = device_ms(lambda: epilogue_gn_swish_quant_whole(*args))
                print(f"[kernels] K6 vs K2 B={batch} HW={HW} N={N}: K6 {ms:.4f} ms (device {dms:.4f}), K2 {ms2:.4f} ms "
                      f"(device {dms2:.4f}; {_fig(f2)}; {plan_fig('K2', HW, N, torch.bfloat16)}), K6's plain version "
                      f"{pms:.4f} ms")
            del args
        if shapes:  # the int32 input mode (the conv's accumulator), at the kernel's largest shape on this path
            HW, N = max(shapes)
            args = args_of(HW, N, torch.int32)
            fn = epilogue_gn_swish_quant_whole if kind == "K2" else epilogue_gn_swish_quant_blocked
            f = _bit_equal(kind, f"HW={HW} N={N} int32", fn(*args), fn(*args, plain=True))
            dms = device_ms(lambda: fn(*args))
            b = bound(nbytes(*args[:8]) + args[0].numel(), f32_flops=18 * args[0].numel())
            print(f"[kernels] {kind} int32 input B={batch} HW={HW} N={N}: {_fig(f)}, bit-equal; device {dms:.4f} ms "
                  f"{_bound_fig(b)}, device at {max(b) / dms:.1%} of it; {plan_fig(kind, HW, N, torch.int32)}")
            del args
    torch.cuda.empty_cache()


def kernel_phase(cfg, batch, gen, dev, report, both_cores=False):
    """Every kernel of the path's serving step (and of its lever steps) against
    its plain version at the step's shapes, timed; `both_cores` also holds
    K3's int8 core at each K3 shape (printed, not counted: the path runs the
    f32 core)."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.fused_gn import epilogue_plan, epilogue_residual_gn_stats, gn_act_quant
    import torch.nn.functional as F

    from attentiondm_tpu_torch.ops.int8_attention import attention_core, fused_attention_block
    from attentiondm_tpu_torch.ops.pallas_conv import int8_conv, k_major
    from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas
    from attentiondm_tpu_torch.ops.precision import exact_f32

    k1, _k2, _k6, k3, _composed = checks.conv_plan(cfg, widths=True)

    def randint8(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    # K1: every distinct (H, Cp, Np, ksize, stride, mode) of a step, weighted by its count.
    # K13 (int32 3x3) is checked at every 3x3 stride-1 shape, and weighted by the
    # path's own int32 launches at that shape (0 where the path runs it in bf16 mode).
    # The bound counts the widths (cin, cout) each launch's conv needs, not the padded Cp, Np.
    counts = collections.Counter(tuple(shape) for _name, *shape, _cin, _cout in k1)
    widths = collections.defaultdict(collections.Counter)  # launch shape -> {(cin, cout): launches}
    for _name, *shape, cin, cout in k1:
        widths[tuple(shape)][cin, cout] += 1
    s1_shapes = sorted({(H, Cp, Np) for (H, Cp, Np, k, s, _m) in counts if k == 3 and s == 1})
    print(f"[kernels] K1 int8_conv: {len(counts)} distinct launch shapes per serving step")
    todo = [(shape, n, "K1") for shape, n in sorted(counts.items(), key=str)]
    todo += [((H, Cp, Np, 3, 1, torch.int32), counts.get((H, Cp, Np, 3, 1, torch.int32), 0), "K13")
             for (H, Cp, Np) in s1_shapes]
    todo += [(shape, n, "K5") for shape, n in sorted(counts.items(), key=str) if shape[3] == 1]
    for (H, Cp, Np, k, s, mode), n, key in todo:
        Hp = H + 2 if (k == 3 and s == 1) else H + 1 if k == 3 else H
        xp = randint8((batch, Hp, Hp, Cp), -128, 127)
        gq = randint8((k * k * Cp, Np), -8, 7)
        inv_ws, zcbias = randf((Np,), 1e-3, 2e-3).abs(), randf((Np,), 0.5)
        args = (xp, gq, inv_ws, zcbias)
        kw = dict(ksize=k, stride=s, out_dtype=mode)
        want = int8_conv(*args, **kw, plain=True)
        _held("K1", f"H={H} Cp={Cp} Np={Np} k={k} s={s} {mode} (weights transposed by the call)",
              int8_conv(*args, **kw), want)
        kw["gqt"] = k_major(gq)  # as the serving path calls it: the fold's K-major copy beside gq
        out = int8_conv(*args, **kw)
        f = _held("K1", f"H={H} Cp={Cp} Np={Np} k={k} s={s} {mode}", out, want)
        del want
        ms = time_ms(lambda: int8_conv(*args, **kw))
        dms = device_ms(lambda: int8_conv(*args, **kw))
        pms = time_ms(lambda: int8_conv(*args, **kw, plain=True), reps=10)
        rows = out.numel() // Np

        def work_bound(cin, cout):  # the conv's own input, weights and output, at its unpadded widths
            return bound(batch * H * H * cin + k * k * cin * cout + rows * cout * out.element_size()
                         + (0 if mode == torch.int32 else 8 * cout),
                         int8_ops=2 * rows * cout * k * k * cin, f32_flops=0 if mode == torch.int32 else 2 * rows * cout)

        # a K13 shape the path runs only in bf16 mode: the widths of those launches, at weight 0
        var = widths.get((H, Cp, Np, k, s, mode)) or {w: 0 for w in widths.get((H, Cp, Np, k, s, torch.bfloat16),
                                                                              {(Cp, Np): 0})}
        lib, lib_fig = None, ""
        if key == "K5":  # the one library call for an int8 product: torch's private cuBLASLt int8 matmul
            a2 = xp.reshape(-1, Cp)
            try:
                lib_out = torch._int_mm(a2, gq)
            except RuntimeError as e:  # the yardstick is not available here: say why, time nothing
                lib_fig = f" torch._int_mm none ({str(e).splitlines()[0][:80]})"
            else:
                if not torch.equal(lib_out.reshape(out.shape), out):
                    raise AssertionError(f"torch._int_mm disagrees with K5 at H={H} Cp={Cp} Np={Np}")
                lib = time_ms(lambda: torch._int_mm(a2, gq))
                lib_fig = f" torch._int_mm {lib:.4f} ms"
                del lib_out
        bound_figs = []
        for (cin, cout), m in sorted(var.items()):
            b = work_bound(cin, cout)
            report.add(key, f["max_abs_err"], ms, pms, b, weight=m, library_ms=lib, dev_ms=dms)
            bound_figs.append(f"{cin}->{cout} x{m}: {_bound_fig(b)}, device at {max(b) / dms:.1%} of it")
        print(f"[kernels] {key} int8_conv B={batch} H={H} Cp={Cp} Np={Np} k={k} s={s} "
              f"{str(mode).removeprefix('torch.')} x{n}/step: {_fig(f)}; kernel {ms:.4f} ms device {dms:.4f} ms "
              f"plain {pms:.4f} ms"
              f"{lib_fig}; {'; '.join(bound_figs)}")
        del xp, gq, args, out

    epilogue_phase(cfg, batch, gen, dev, report)

    # K3: every attention shape (the k projection at a_bit 6, as the W4A8 policy)
    for (L, C), n in sorted(collections.Counter(k3).items()):
        x = randf((batch, L, C)).to(torch.bfloat16)
        qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b) for b in (8, 6, 8)]
        qkv_weights = [weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 2e-4).abs(), randf((C,), 0.1))
                       for _ in range(3)]
        o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
        o_weights = weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 1e-3).abs(), randf((C,), 0.1))
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant, qkv_weights, o_quant, o_weights)
        f = _held("K3", f"L={L} C={C}", fused_attention_block(*args, scale=C ** -0.5),
                  fused_attention_block(*args, scale=C ** -0.5, plain=True))
        ms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        dms = device_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        pms = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5, plain=True), reps=10)
        # in and out residual, four folds; int8 projections, f32 core (q k^T and p v as 3xTF32), ~30 f32 per
        # element around and 5 per logit
        b = bound(2 * nbytes(x) + 4 * C * C + 16 * 4 * C, int8_ops=4 * 2 * batch * L * C * C,
                  tf32x3_flops=2 * 2 * batch * L * L * C, f32_flops=30 * x.numel() + 5 * batch * L * L)
        report.add("K3", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K3 fused_attention_block B={batch} L={L} C={C} x{n}/step: {_fig(f)}; "
              f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        if both_cores:
            def k3_int8(plain=False):
                return fused_attention_block(*args, scale=C ** -0.5, int8_core=True, plain=plain)

            f8 = _held("K3", f"L={L} C={C} int8 core", k3_int8(), k3_int8(plain=True))
            ms8, dms8 = time_ms(k3_int8), device_ms(k3_int8)
            b8 = bound(2 * nbytes(x) + 4 * C * C + 16 * 4 * C,
                       int8_ops=4 * 2 * batch * L * C * C + 2 * batch * L * L * C,
                       tf32x3_flops=2 * batch * L * L * C, f32_flops=30 * x.numel() + 5 * batch * L * L)
            print(f"[kernels] K3 fused_attention_block(int8_core) B={batch} L={L} C={C} (checked, not on this path's "
                  f"count): {_fig(f8)}; kernel {ms8:.4f} ms device {dms8:.4f} ms {_bound_fig(b8)}")
        del x, args

        # K3's core alone on f32 q, k, v of a few units; F.scaled_dot_product_attention computes its function
        # up to the int8 quantization of the output (timed, not held)
        q, k, v = (randf((batch, L, C)) for _ in range(3))
        so, zo = torch.full((C,), 255 / 4.0, device=dev), randf((C,), 3.0).round()

        def core(plain=False):
            return attention_core(q, k, v, so, zo, 8, scale=C ** -0.5, plain=plain)

        f = _held("K3.core", f"L={L} C={C}", core(), core(plain=True))
        ms, dms = time_ms(core), device_ms(core)
        pms = time_ms(lambda: core(plain=True), reps=10)
        with exact_f32():
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=C ** -0.5))
        b = bound(3 * nbytes(q) + q.numel() + 2 * 4 * C, tf32x3_flops=2 * 2 * batch * L * L * C,
                  f32_flops=5 * batch * L * L)
        report.add("K3.core", f["max_abs_err"], ms, pms, b, weight=n, library_ms=lib, dev_ms=dms)
        print(f"[kernels] K3.core attention_core B={batch} L={L} C={C} x{n}/step: {_fig(f)}; kernel {ms:.4f} ms "
              f"device {dms:.4f} ms plain {pms:.4f} ms F.scaled_dot_product_attention {lib:.4f} ms {_bound_fig(b)}")
        del q, k, v
    torch.cuda.empty_cache()

    # K4, K7, K12: every shape a step launches under the three levers together (the
    # weight n of the JSON line's sums) or under one lever alone (m, printed)
    plans = {name: checks.lever_plan(cfg, batch, **kw) for name, kw in LEVER_SETS.items()}
    alone = {"K4": "entry_pallas", "K7": "boundary_fusion", "K12": "resblock_pallas=all"}

    def shapes(kind):
        both = collections.Counter(tuple(shape) for _site, *shape in plans["all three"][kind])
        single = collections.Counter(tuple(shape) for _site, *shape in plans[alone[kind]][kind])
        return [(shape, both[shape], single[shape]) for shape in sorted(set(both) | set(single))]

    def quant(C, lo, hi):  # an 8-bit range [lo, hi] as (scale, zero point)
        sc = 255 / (hi - lo)
        return torch.full((C,), sc, device=dev), torch.full((C,), round(sc * lo) + 128.0, device=dev)

    def plan_fig(HW, C, dtype):
        p = epilogue_plan(batch, HW, C, dtype, "K4")
        if p["form"] == "image":
            return (f"image form, {p['slices']} channel slice(s) an image, a block a slice, "
                    f"{p['row_groups']} row groups, {p['threads']} threads")
        return (f"cluster form, {p['cluster']} blocks an image, {p['rows']} rows a block, {p['threads']} threads, "
                f"slab {'held in shared memory' if p['held'] else 're-read from L2'}")

    for (HW, C), n, m in shapes("K4"):  # bf16 residual, one output, swish; one group at offset 40
        x = randf((batch, HW, C), 2.0, 0.3)
        x[..., :C // 32] += 40.0
        x = x.to(torch.bfloat16)
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), [(*quant(C, -0.5, 4.0), 8)])
        f = _bit_equal("K4", f"HW={HW} C={C}", gn_act_quant(*args), gn_act_quant(*args, plain=True))
        ms = time_ms(lambda: gn_act_quant(*args))
        dms = device_ms(lambda: gn_act_quant(*args))
        pms = time_ms(lambda: gn_act_quant(*args, plain=True), reps=10)
        b = bound(nbytes(x) + x.numel() + 4 * 4 * C, f32_flops=16 * x.numel())  # 12 + 4 per output, as the TPU estimate
        report.add("K4", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K4 gn_act_quant B={batch} HW={HW} C={C} x{n}/step (entry_pallas alone x{m}): {_fig(f)}, "
              f"bit-equal; kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}, device at "
              f"{max(b) / dms:.1%} of it; plan: {plan_fig(HW, C, torch.bfloat16)}")
        del x, args

    # K7 as the serving path calls it at an identity-shortcut exit: bf16 conv2 output (identity dequant), the
    # bf16 residual stream (one channel group at offset 40), bf16 out
    for (HW, N), n, m in shapes("K7"):
        H = int(HW ** 0.5)
        dot = randf((batch, H, H, N), 1.5, 0.2).to(torch.bfloat16)
        x_res = randf((batch, H, H, N), 2.0, 0.5)
        x_res[..., :N // 32] += 40.0
        args = (dot, torch.ones(N, device=dev), torch.zeros(N, device=dev), x_res.to(torch.bfloat16))
        kw = dict(out_dtype=torch.bfloat16)
        got = epilogue_residual_gn_stats(*args, **kw)
        f = _bit_equal("K7", f"HW={HW} N={N}", got, epilogue_residual_gn_stats(*args, **kw, plain=True))
        ms = time_ms(lambda: epilogue_residual_gn_stats(*args, **kw))
        dms = device_ms(lambda: epilogue_residual_gn_stats(*args, **kw))
        pms = time_ms(lambda: epilogue_residual_gn_stats(*args, **kw, plain=True), reps=10)
        b = bound(nbytes(*args, *got), f32_flops=8 * dot.numel())
        report.add("K7", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        p = epilogue_plan(batch, HW, N, torch.bfloat16, "K7")
        print(f"[kernels] K7 epilogue_residual_gn_stats B={batch} HW={HW} N={N} x{n}/step (boundary_fusion alone "
              f"x{m}): {_fig(f)}, bit-equal; kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms "
              f"{_bound_fig(b)}, device at {max(b) / dms:.1%} of it; plan: image form, {p['slices']} channel "
              f"slice(s) an image, a block a slice, {p['row_groups']} row groups, {p['threads']} threads, "
              f"{p['vec']} channels a thread")
        del dot, x_res, args, got

    for (H, C), n, m in shapes("K12"):
        def fold():
            return randint8((9 * C, C), -8, 7), (randf((C,), 2e-5, 2e-4).abs(), randf((C,), 0.1))

        (g1, sb1), (g2, sb2) = fold(), fold()
        r = randf((batch, H, H, C), 1.5, 0.2).to(torch.bfloat16)
        args = (r, randf((batch, C)), randf((C,), 0.1, 1.0), randf((C,), 0.1), quant(C, -0.5, 4.0), g1, sb1,
                randf((C,), 0.1, 1.0), randf((C,), 0.1), quant(C, -0.5, 3.0), g2, sb2)
        kt = dict(g1_t=k_major(g1), g2_t=k_major(g2))  # as the serving path calls it
        f = _bit_equal("K12", f"H={H} C={C}", resblock_pallas(*args, **kt), resblock_pallas(*args, plain=True))
        ms = time_ms(lambda: resblock_pallas(*args, **kt))
        dms = device_ms(lambda: resblock_pallas(*args, **kt))
        pms = time_ms(lambda: resblock_pallas(*args, plain=True), reps=10)
        # residual in and out, both folds; two int8 convs, the entry's 16 and the epilogue's 18 f32 per element
        b = bound(2 * nbytes(r) + nbytes(g1, g2) + 4 * batch * C + 12 * 4 * C,
                  int8_ops=2 * 2 * r.numel() * 9 * C, f32_flops=(16 + 18 + 3) * r.numel())
        report.add("K12", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K12 resblock_pallas B={batch} H={H} C={C} x{n}/step (resblock_pallas=all alone x{m}): "
              f"{_fig(f)}, bit-equal; kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}, "
              f"device at {max(b) / dms:.1%} of it; GroupNorm plans: {plan_fig(H * H, C, torch.bfloat16)} (GN1); "
              f"{plan_fig(H * H, C, torch.int32)} (GN2)")
        del r, args, g1, g2, kt
    torch.cuda.empty_cache()


def attention_kernel_phase(cfg, batch, gen, dev, report):
    """K10, K9, K8, K11 and K3's int8 core against their plain versions at
    every shape one serving step gives them under the three attention
    settings, weighted by the launches of the step that runs them."""
    import torch
    import torch.nn.functional as F

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.attention import flash_attention
    from attentiondm_tpu_torch.ops.int8_attention import (
        fused_attention_block,
        fused_int8_attention,
        fused_int8_attention_static,
    )
    from attentiondm_tpu_torch.ops.precision import exact_f32

    plans = {name: checks.attention_plan(cfg, **flags) for name, flags in ATTN_SETTINGS.items()}
    for name, plan in plans.items():
        print(f"[kernels] attention cores of a step, {name}: "
              + ", ".join(f"{k} x{len(v)} {sorted(set(v))}" for k, v in plan.items() if v))

    def randint8(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    def out_quant(C):  # proj_out's input quantization: 8 bits over about [-2, 2], integral zero points
        return torch.full((C,), 255 / 4.0, device=dev), randf((C,), 3.0).round()

    def run(kind, label, n, fn, b, library=None):
        got = fn()
        f = _held("K3" if kind == "K3.int8_core" else kind, label, got, fn(plain=True))
        del got
        ms = time_ms(fn)
        dms = device_ms(fn)
        pms = time_ms(lambda: fn(plain=True), reps=5)
        lib, lib_fig = None, ""
        if library is not None:
            lib = time_ms(library, reps=10)
            lib_fig = f" F.scaled_dot_product_attention {lib:.4f} ms"
        report.add(kind, f["max_abs_err"], ms, pms, b, weight=n, library_ms=lib, dev_ms=dms)
        print(f"[kernels] {kind} {label} x{n}/step: {_fig(f)}; kernel {ms:.4f} ms device {dms:.4f} ms "
              f"plain {pms:.4f} ms{lib_fig} {_bound_fig(b)}")
        torch.cuda.empty_cache()

    # K10 and K9: int8 q, k, v at scalar scales of absmax 2.4 / 127 (logits of a few units), sv 0.02
    static = plans["static int8"]
    for kind in ("K10", "K9"):
        for (L, C), n in sorted(collections.Counter(static[kind]).items()):
            q8, k8, v8 = (randint8((batch, L, C), -127, 127) for _ in range(3))
            sq, sk, sv = (torch.tensor(x, device=dev) for x in (0.019, 0.021, 0.02))
            osc, ozp = out_quant(C)
            b = bound(4 * q8.numel() + 8 * C + 12, int8_ops=2 * batch * L * L * C, bf16_flops=2 * batch * L * L * C,
                      f32_flops=5 * batch * L * L)
            run(kind, f"B={batch} L={L} C={C}", n, lambda plain=False: fused_int8_attention_static(
                q8, k8, v8, sq, sk, sv, osc, ozp, 8, scale=C ** -0.5, plain=plain), b)
            del q8, k8, v8
    # K8: int32 projection accumulators that dequantize to a few units
    for (L, C), n in sorted(collections.Counter(plans["dynamic int8"]["K8"]).items()):
        dots = [torch.randint(-20000, 20000, (batch, L, C), generator=gen, dtype=torch.int32).to(dev) for _ in range(3)]
        epis = [(randf((C,), 2e-5, 1e-4).abs(), randf((C,), 0.2)) for _ in range(3)]
        osc, ozp = out_quant(C)
        b = bound(13 * dots[0].numel() + 8 * 4 * C, int8_ops=2 * batch * L * L * C, bf16_flops=2 * batch * L * L * C,
                  f32_flops=5 * batch * L * L + 3 * 4 * dots[0].numel())
        run("K8", f"B={batch} L={L} C={C}", n, lambda plain=False: fused_int8_attention(
            *dots, *epis, osc, ozp, 8, scale=C ** -0.5, plain=plain), b)
        del dots
    # K11: f32 q, k, v; F.scaled_dot_product_attention computes the same function (its result is printed, not held)
    for (L, D), n in sorted(collections.Counter(plans["f32 core"]["K11"]).items()):
        q, k, v = (randf((batch, L, D)) for _ in range(3))
        with exact_f32():
            lib_out = F.scaled_dot_product_attention(q, k, v, scale=D ** -0.5)
            lib_err = (lib_out - flash_attention(q, k, v)).abs().max().item()
            del lib_out
            b = bound(4 * 4 * q.numel(), f32_flops=4 * batch * L * L * D + 5 * batch * L * L)
            run("K11", f"B={batch} L={L} D={D}", n, lambda plain=False: flash_attention(q, k, v, plain=plain), b,
                library=lambda: F.scaled_dot_product_attention(q, k, v, scale=D ** -0.5))
        print(f"[kernels] K11 B={batch} L={L} D={D}: max abs difference from F.scaled_dot_product_attention "
              f"{lib_err:.3e} (information only)")
        del q, k, v
    # K3 with the int8 core, at the shapes of kernel_phase's K3 check
    for (L, C), n in sorted(collections.Counter(static["K3.int8_core"]).items()):
        x = randf((batch, L, C)).to(torch.bfloat16)
        qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b_) for b_ in (8, 6, 8)]
        qkv_weights = [weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 2e-4).abs(), randf((C,), 0.1))
                       for _ in range(3)]
        o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
        o_weights = weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 1e-3).abs(), randf((C,), 0.1))
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant, qkv_weights, o_quant, o_weights)
        # as K3's bound, with q k^T in int8
        b = bound(2 * nbytes(x) + 4 * C * C + 16 * 4 * C, int8_ops=4 * 2 * batch * L * C * C + 2 * batch * L * L * C,
                  tf32x3_flops=2 * batch * L * L * C, f32_flops=30 * x.numel() + 5 * batch * L * L)
        run("K3.int8_core", f"fused_attention_block(int8_core) B={batch} L={L} C={C}", n,
            lambda plain=False: fused_attention_block(*args, scale=C ** -0.5, int8_core=True, plain=plain), b)
        ms32 = time_ms(lambda: fused_attention_block(*args, scale=C ** -0.5))
        print(f"[kernels] K3 B={batch} L={L} C={C}: the f32 core on the same inputs {ms32:.4f} ms")
        del x, args
    torch.cuda.empty_cache()


def f32_kernel_phase(cfg, batch, gen, dev, report):
    """The kernels the float32 stream, dot_bf16=False and the interception
    runtime reach, each against its plain version at the shapes its CIFAR-10
    step gives it, timed: K3 at a float32 residual (K3's tolerance restated
    for an f32 output; also church's (32, 256, 512) and imagenet64's (32,
    64, 1024), checked and printed, not counted), K12 at f32 (bit-equal), K1's
    f32 residual-add epilogue at K3's and K12's last GEMM (bit-equal), K4 on
    the f32 stream and K7 with an f32 residual and output at the lever
    shapes, K2 on conv1's int32 accumulator (dot_bf16=False), and K13 / K5
    (K1's int32 3x3 and 1x1 modes) at every conv of the interception
    runtime's step, weighted by that step's launches."""
    import torch

    from attentiondm_tpu_torch.models.unet import iter_conv_layers
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.fused_gn import epilogue_gn_swish_quant, epilogue_residual_gn_stats, gn_act_quant
    from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
    from attentiondm_tpu_torch.ops.pallas_conv import int8_conv, k_major
    from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas
    from attentiondm_tpu_torch.quant.int8_runtime import _eligible

    f32 = torch.float32

    def randint8(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    def timed(fn, plain_reps=10):
        return time_ms(fn), device_ms(fn), time_ms(lambda: fn(plain=True), reps=plain_reps)

    def quant(C, lo, hi):  # an 8-bit range [lo, hi] as (scale, zero point)
        sc = 255 / (hi - lo)
        return torch.full((C,), sc, device=dev), torch.full((C,), round(sc * lo) + 128.0, device=dev)

    # K3 at a float32 residual: CIFAR-10's shapes (counted), church's and imagenet64's (checked)
    _k1, _k2, _k6, k3, _composed = checks.conv_plan(cfg)
    k3_shapes = [(batch, L, C, n) for (L, C), n in sorted(collections.Counter(k3).items())]
    for B, L, C, n in k3_shapes + [(32, 256, 512, 0), (32, 64, 1024, 0)]:
        x = randf((B, L, C), 2.0, 0.3)
        qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b) for b in (8, 6, 8)]
        qkv_weights = [weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 2e-4).abs(), randf((C,), 0.1))
                       for _ in range(3)]
        o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
        o_weights = weights_kmajor(randint8((C, C), -8, 7), randf((C,), 1e-5, 1e-3).abs(), randf((C,), 0.1))
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant, qkv_weights, o_quant, o_weights)

        def k3_call(plain=False):
            return fused_attention_block(*args, scale=C ** -0.5, plain=plain)

        f = _held("K3", f"f32 residual B={B} L={L} C={C}", k3_call(), k3_call(plain=True))
        ms, dms, pms = timed(k3_call)
        # f32 residual in and out, four folds; the projections int8, the core 3xTF32 (as K3's bf16 bound)
        b = bound(2 * nbytes(x) + 4 * C * C + 16 * 4 * C, int8_ops=4 * 2 * B * L * C * C,
                  tf32x3_flops=2 * 2 * B * L * L * C, f32_flops=30 * x.numel() + 5 * B * L * L)
        if n:
            report.add("K3.f32", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K3 fused_attention_block, f32 residual, B={B} L={L} C={C} x{n}/step: {_fig(f)}; "
              f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        if n:  # K1's f32 residual-add mode alone at proj_out's GEMM: [B * L, C] rows
            o8 = randint8((B, L, 1, C), -128, 127)
            gq, iw, zc, gqt = o_weights
            res = x.reshape(B, L, 1, C)

            def resadd(plain=False):
                return int8_conv(o8, gq, iw, zc, ksize=1, out_dtype=f32, gqt=gqt, res=res, plain=plain)

            f1 = _bit_equal("K1", f"f32 residual add, 1x1 {B * L}x{C}", resadd(), resadd(plain=True))
            ms1, dms1, pms1 = timed(resadd)
            b1 = bound(o8.numel() + C * C + 2 * nbytes(res) + 8 * C, int8_ops=2 * B * L * C * C,
                       f32_flops=3 * res.numel())
            report.add("K1.resadd_f32", f1["max_abs_err"], ms1, pms1, b1, weight=n, dev_ms=dms1)
            print(f"[kernels] K1 int8_conv f32 residual add (K3's last launch) 1x1 rows={B * L} C={C} x{n}/step: "
                  f"{_fig(f1)}, bit-equal; kernel {ms1:.4f} ms device {dms1:.4f} ms plain {pms1:.4f} ms "
                  f"{_bound_fig(b1)}")
        del x, args
    torch.cuda.empty_cache()

    # K4, K7 and K12 on the float32 stream at the three-lever step's shapes (bit-equal)
    plan = checks.lever_plan(cfg, batch, **ALL_LEVERS)
    for (HW, C), n in sorted(collections.Counter((HW, C) for _s, HW, C in plan["K4"]).items()):
        x = randf((batch, HW, C), 2.0, 0.3)
        x[..., :C // 32] += 40.0
        args = (x, randf((C,), 0.1, 1.0), randf((C,), 0.1), [(*quant(C, -0.5, 4.0), 8)])

        def k4(plain=False):
            return gn_act_quant(*args, plain=plain)

        f = _bit_equal("K4", f"f32 HW={HW} C={C}", k4(), k4(plain=True))
        ms, dms, pms = timed(k4)
        b = bound(nbytes(x) + x.numel() + 4 * 4 * C, f32_flops=16 * x.numel())
        report.add("K4.f32", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K4 gn_act_quant, f32 residual, B={batch} HW={HW} C={C} x{n}/step: {_fig(f)}, bit-equal; "
              f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
    for (HW, N), n in sorted(collections.Counter((HW, N) for _s, HW, N in plan["K7"]).items()):
        H = int(HW ** 0.5)
        dot = randf((batch, H, H, N), 1.5, 0.2).to(torch.bfloat16)
        x_res = randf((batch, H, H, N), 2.0, 0.5)
        x_res[..., :N // 32] += 40.0
        args = (dot, torch.ones(N, device=dev), torch.zeros(N, device=dev), x_res)

        def k7(plain=False):
            return epilogue_residual_gn_stats(*args, out_dtype=f32, plain=plain)

        got = k7()
        f = _bit_equal("K7", f"f32 residual HW={HW} N={N}", got, k7(plain=True))
        ms, dms, pms = timed(k7)
        b = bound(nbytes(*args, *got), f32_flops=8 * dot.numel())
        report.add("K7.f32", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K7 epilogue_residual_gn_stats, f32 residual and out, B={batch} HW={HW} N={N} x{n}/step: "
              f"{_fig(f)}, bit-equal; kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        del got
    for (H, C), n in sorted(collections.Counter((H, C) for _s, H, C in plan["K12"]).items()):
        def fold():
            return randint8((9 * C, C), -8, 7), (randf((C,), 2e-5, 2e-4).abs(), randf((C,), 0.1))

        (g1, sb1), (g2, sb2) = fold(), fold()
        r = randf((batch, H, H, C), 1.5, 0.2)
        args = (r, randf((batch, C)), randf((C,), 0.1, 1.0), randf((C,), 0.1), quant(C, -0.5, 4.0), g1, sb1,
                randf((C,), 0.1, 1.0), randf((C,), 0.1), quant(C, -0.5, 3.0), g2, sb2)
        kt = dict(g1_t=k_major(g1), g2_t=k_major(g2), out_dtype=f32)

        def k12(plain=False):
            return resblock_pallas(*args, **kt, plain=plain)

        f = _bit_equal("K12", f"f32 H={H} C={C}", k12(), k12(plain=True))
        ms, dms, pms = timed(k12)
        b = bound(2 * nbytes(r) + nbytes(g1, g2) + 4 * batch * C + 12 * 4 * C,
                  int8_ops=2 * 2 * r.numel() * 9 * C, f32_flops=(16 + 18 + 3) * r.numel())
        report.add("K12.f32", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K12 resblock_pallas, f32 residual, B={batch} H={H} C={C} x{n}/step: {_fig(f)}, bit-equal; "
              f"kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
        # K1's f32 residual-add mode alone at conv2's GEMM: the halo'd int8 input, r added
        xp = randint8((batch, H + 2, H + 2, C), -128, 127)

        def resadd(plain=False):
            return int8_conv(xp, g2, *sb2, ksize=3, out_dtype=f32, gqt=kt["g2_t"], res=r, plain=plain)

        f1 = _bit_equal("K1", f"f32 residual add, 3x3 H={H} C={C}", resadd(), resadd(plain=True))
        ms1, dms1, pms1 = timed(resadd)
        b1 = bound(batch * H * H * C + 9 * C * C + 2 * nbytes(r) + 8 * C, int8_ops=2 * r.numel() * 9 * C,
                   f32_flops=3 * r.numel())
        report.add("K1.resadd_f32", f1["max_abs_err"], ms1, pms1, b1, weight=n, dev_ms=dms1)
        print(f"[kernels] K1 int8_conv f32 residual add (K12's last launch) 3x3 H={H} C={C} x{n}/step: {_fig(f1)}, "
              f"bit-equal; kernel {ms1:.4f} ms device {dms1:.4f} ms plain {pms1:.4f} ms {_bound_fig(b1)}")
        del r, args, xp
    torch.cuda.empty_cache()

    # K2 on conv1's int32 accumulator (dot_bf16=False), every epilogue shape of the step
    _k1, k2, _k6, _k3, _composed = checks.conv_plan(cfg, dot_bf16=False)
    for (HW, N), n in sorted(collections.Counter(k2).items()):
        H = int(HW ** 0.5)
        dot = torch.randint(-20000, 20000, (batch, H, H, N), generator=gen, dtype=torch.int32).to(dev)
        zcbias = randf((N,))
        zcbias[:N // 32] += 40.0
        args = (dot, randf((N,), 2e-5, 1e-4).abs(), zcbias, randf((batch, N)), randf((N,), 0.1, 1.0), randf((N,), 0.1),
                torch.full((N,), 255 / 4.5, device=dev), torch.full((N,), round(255 / 4.5 * -0.5) + 128.0, device=dev),
                8)

        def k2(plain=False):
            return epilogue_gn_swish_quant(*args, plain=plain)

        f = _bit_equal("K2", f"int32 HW={HW} N={N}", k2(), k2(plain=True))
        ms, dms, pms = timed(k2)
        b = bound(nbytes(*args[:8]) + dot.numel(), f32_flops=18 * dot.numel())
        report.add("K2.int32", f["max_abs_err"], ms, pms, b, weight=n, dev_ms=dms)
        print(f"[kernels] K2 epilogue_gn_swish_quant, int32 accumulator, B={batch} HW={HW} N={N} x{n}/step: "
              f"{_fig(f)}, bit-equal; kernel {ms:.4f} ms device {dms:.4f} ms plain {pms:.4f} ms {_bound_fig(b)}")
    torch.cuda.empty_cache()

    # K13 / K5: every conv of the interception runtime's step (the folded convs at stride 1), by shape
    levels = len(cfg.ch_mult)
    convs = collections.Counter()
    for name, cin, k in iter_conv_layers(cfg):
        parts = name.split(".")
        if parts[-2:-1] == ["downsample"] or not _eligible((k, k, cin, 0)):
            continue
        lvl = levels - 1 if parts[0] == "mid" else 0 if parts[0] == "conv_out" else int(parts[1])
        H = (cfg.resolution >> lvl) * (2 if parts[-2:-1] == ["upsample"] else 1)
        cout = (cfg.out_ch if parts[0] == "conv_out" else cin if ".attn" in name or parts[-2:-1] == ["upsample"]
                or parts[0] == "mid" else cfg.ch * cfg.ch_mult[lvl])
        convs[H, cin, cout, k] += 1
    for (H, cin, cout, k), n in sorted(convs.items()):
        key = "K13" if k == 3 else "K5"
        Cp, Np = -(-cin // 128) * 128, -(-cout // 128) * 128
        xp = randint8((batch, H + k - 1, H + k - 1, Cp), -128, 127)
        gq = randint8((k * k * Cp, Np), -8, 7)
        gqt = k_major(gq)

        def prod(plain=False):
            return int8_conv(xp, gq, ksize=k, gqt=gqt, plain=plain)

        f = _bit_equal(key, f"H={H} {cin}->{cout}", prod(), prod(plain=True))
        ms, dms, pms = timed(prod, plain_reps=3)
        rows = batch * H * H
        b = bound(rows * cin + k * k * cin * cout + 4 * rows * cout, int8_ops=2 * rows * cout * k * k * cin)
        lib, lib_fig = None, ""
        if k == 1:  # the one library call for an int8 product: torch's private cuBLASLt int8 matmul, as kernel_phase
            a2 = xp.reshape(-1, Cp)
            try:
                lib_out = torch._int_mm(a2, gq)
            except RuntimeError as e:  # the yardstick is not available here: say why, time nothing
                lib_fig = f" torch._int_mm none ({str(e).splitlines()[0][:80]})"
            else:
                if not torch.equal(lib_out.reshape(rows, Np), prod().reshape(rows, Np)):
                    raise AssertionError(f"torch._int_mm disagrees with K5 at H={H} {cin}->{cout}")
                lib = time_ms(lambda: torch._int_mm(a2, gq))
                lib_fig = f" torch._int_mm {lib:.4f} ms"
                del lib_out
        report.add(key, f["max_abs_err"], ms, pms, b, weight=n, library_ms=lib, dev_ms=dms)
        print(f"[kernels] {key} int8_conv int32 {k}x{k} B={batch} H={H} {cin}->{cout} (Cp={Cp} Np={Np}) x{n} a "
              f"forward of the interception runtime: {_fig(f)}; kernel {ms:.4f} ms device {dms:.4f} ms plain "
              f"{pms:.4f} ms{lib_fig} {_bound_fig(b)}")
        del xp, gq, gqt
    torch.cuda.empty_cache()


F32_STREAM = "f32 stream"  # the f32 path's levers-off run: the float32 residual stream, the f32 attention core


def f32_phase(ctx):
    """The float32 stream's serving runs on the slice's params, calibration
    and fold (its levers-off run is the slice's own): the three levers,
    dot_bf16=False, conv_pallas=True (held bit-equal to conv_pallas=False),
    each launch-counted and checked site by site; then one run of each of
    these samplers and of the bf16 stream's (levers off and on) replayed as
    a CUDA graph in one call (`graph_ms`), the device times beside each
    other.  Returns {run: launch counts}."""
    import torch

    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    x, steps, batch = ctx["x"], ctx["steps"], ctx["batch"]
    f32 = dict(residual_dtype=torch.float32, **F32_CORE)
    runs = {"three levers": {**f32, **ALL_LEVERS}, "dot_bf16=False": {**f32, "dot_bf16": False},
            "conv_pallas=True": {**f32, "conv_pallas": True}}
    counts = {}
    for name, flags in runs.items():
        _sample, out, counts[name] = run_sampler(ctx, f"f32 stream, {name}", flags, "f32")
        if name == "conv_pallas=True":
            same = torch.equal(out, ctx["out"])
            print(f"[f32] conv_pallas=True: bit-equal to conv_pallas=False: {same}")
            if not same:
                raise AssertionError("conv_pallas=True changed the f32 stream's sample")
        else:
            rel = ((out - ctx["out"]).abs().mean() / ctx["out"].abs().mean()).item()
            print(f"[f32] {name}: sample's mean rel difference from the levers-off f32 sample {rel:.3e} "
                  f"(information only: another quantization path)")
        del out

    def sampler(**flags):
        return serving_ddim_sampler(ctx["qunet"], ctx["params"], ctx["qstates"], ctx["seq"], ctx["betas"],
                                    runtime=ctx["runtime"], **flags)

    timed = {"bf16 stream, levers off": dict(residual_dtype=torch.bfloat16, **F32_CORE),
             "bf16 stream, three levers": dict(residual_dtype=torch.bfloat16, **F32_CORE, **ALL_LEVERS),
             "f32 stream, levers off": f32, "f32 stream, three levers": runs["three levers"],
             "f32 stream, dot_bf16=False": runs["dot_bf16=False"]}
    for name, flags in timed.items():
        fn = sampler(**flags)
        wall = min(time_ms(lambda: fn(x), reps=1) for _ in range(2))
        dev_ms = graph_ms(lambda: fn(x))
        print(f"[f32] serving sampler, {name}: device {dev_ms:.1f} ms for {steps} steps at batch {batch} "
              f"({batch / dev_ms * 1e3:.2f} images/s at the device's rate), wall {wall:.1f} ms "
              f"({batch / wall * 1e3:.2f} images/s); one run replayed as a CUDA graph")
    torch.cuda.empty_cache()
    return counts


def interception_phase(ctx):
    """The interception runtime on the slice's params and calibration:
    `prepare_int8_runtime` with symmetric and with asymmetric folds, each
    driven as a --steps DDIM sampler through `int8_model_fn` (launch counts
    against `checks.interception_launches`, a finite sample), one step held
    site by site (K13 / K5 against their plain versions) and chained against
    the plain step, its device time (a CUDA graph); then one
    `QuantizedUNet.apply(mode="int8")` forward on the `prepare_params`
    weights, counted and held site by site.  Returns the asymmetric
    sampler's launch counts."""
    import torch

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_runtime import int8_model_fn, prepare_int8_runtime

    cfg, q, params, qstates, x = ctx["cfg"], ctx["qunet"], ctx["params"], ctx["qstates"], ctx["x"]
    steps, batch = ctx["steps"], ctx["batch"]
    t0 = torch.full((batch,), float(ctx["seq"][-1]), device=ctx["dev"])
    expected = checks.interception_launches(cfg, steps)
    outs, counts = {}, None
    for label, sym in (("symmetric", True), ("asymmetric", False)):
        rt = clock(f"{label} interception fold ({steps} steps)",
                   lambda: prepare_int8_runtime(q, params, qstates, symmetric=sym), "interception")

        def fn(plain=False):
            return int8_model_fn(q, rt, params, qstates, symmetric=sym, plain=plain)

        checks.reset_launches()
        out = clock(f"int8_model_fn DDIM sampler, {label} folds ({steps} steps, batch {batch})",
                    lambda: ddim_sample(fn(), x, ctx["seq"], ctx["betas"]), "interception")
        counts = checks.read_launches()
        print(f"[interception] {label}: launches {counts}, expected {expected}")
        if counts != expected:
            raise AssertionError(f"interception {label}: launch counts {counts} != expected {expected}")
        if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"interception {label}: output {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        held_step(lambda plain: fn(plain)(x, t0, 0), "interception")
        # one step replayed as a CUDA graph (the sampler's schedule is built on the host per call, which a
        # capture cannot hold; every step does the same work)
        model = fn()
        dev_ms = graph_ms(lambda: model(x, t0, 0))
        print(f"[interception] {label} sampler: device {dev_ms:.2f} ms a step (one step replayed as a CUDA graph), "
              f"{steps * dev_ms:.1f} ms for {steps} steps at batch {batch}; the f32 stream's levers-off sample lies "
              f"{_rel(out, ctx['out']):.3e} from it (information only)")
        outs[label] = out
        del rt
    print(f"[interception] asymmetric vs symmetric folds: samples {_rel(outs['asymmetric'], outs['symmetric']):.3e} "
          f"apart (information only)")

    qparams, _ = q.prepare_params(params)
    want = checks.interception_launches(cfg, 1)
    records = []
    checks.reset_launches()
    with checks.per_site(records):
        eps = clock("QuantizedUNet.apply(mode=\"int8\"), one forward", lambda: q.apply(qparams, qstates, x, t0, 0,
                                                                                      mode="int8"), "interception")
    got = checks.read_launches()
    bad = [r for r in records if not r[2]["ok"]]
    print(f"[interception] qunet mode int8: launches {got}, expected {want}; {len(records)} sites, {len(bad)} off "
          f"tolerance; finite {bool(torch.isfinite(eps).all())}")
    if got != want or bad or not bool(torch.isfinite(eps).all()):
        raise AssertionError(f"qunet mode int8: launches {got} (expected {want}), sites off tolerance {bad[:5]}")
    torch.cuda.empty_cache()
    return counts


def _rel(a, b):
    return ((a - b).abs().mean() / b.abs().mean()).item()


def clock(what, fn, tag="slice"):
    """Run fn between synchronizations and print its host-clock seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"[{tag}] {what}: {time.perf_counter() - t0:.2f} s")
    return out


# `--profile`: (label, run, wall ms[, split]) of each sampler (and the training step, split), profiled after every
# phase has run, so that no timed run has a profiler window before it
DEFERRED_PROFILES = []


# cuDNN's and cuBLAS's kernels, by name: the convolutions (implicit GEMM, FFT, Winograd), their layout transposes
# and the dense GEMMs; a training step's profile sums its kernels into these and the rest (plain-torch passes)
LIBRARY_KERNELS = ("cudnn", "xmma", "gemm", "fft", "complex", "dgrad", "wgrad", "fprop", "Nchw", "Nhwc", "nchw",
                   "nhwc", "conv", "cutlass", "winograd")


def profile_sampler(label, run, wall_ms, top: int = 25, split: bool = False):
    """torch.profiler over one run of a sampler (or a training step): device
    time per kernel, and its share of the run's wall time; with `split`, the
    kernels' sum in cuDNN / cuBLAS's (`LIBRARY_KERNELS`) and the rest.
    Autograd's nodes and the runtime's markers, which carry their kernels'
    time again, are left out."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", 0)
        if (dt and not e.key.startswith(("aten::", "cuda", "autograd::")) and not re.search(r"Backward\d*$", e.key)
                and e.key not in ("Command Buffer Full", "torch::autograd::AccumulateGrad")):
            rows.append((dt / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"[profile] {label}: device kernel time {total:.1f} ms over one run of {wall_ms:.1f} ms wall "
          f"(timed without the profiler)")
    if split:
        lib = sum(ms for ms, _, key in rows if any(k in key for k in LIBRARY_KERNELS))
        print(f"[profile] {label}: cuDNN / cuBLAS kernels (convolutions, GEMMs, their transposes) {lib:.1f} ms "
              f"({lib / total:.1%}), the rest (elementwise passes, reductions, copies) {total - lib:.1f} ms")
    for ms, n, key in rows[:top]:
        print(f"[profile] {ms:9.2f} ms {n:6d}x {ms / total * 100:5.1f}% {key[:100]}")


def slice_phase(cfg, sched, label, steps, batch, gen, dev, profile=False, settings=None):
    """Drive the path's sampler through the kernels, once per attention
    setting ({name: flags}; default: the f32 core alone); returns the launch
    counts of each setting's counted run, and the context of the last one."""
    import torch

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, make_timestep_seq
    from attentiondm_tpu_torch.models.unet import count_params, unet_apply, unet_init
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.ops.attention import flash_attention
    from attentiondm_tpu_torch.quant.calibrate import calibrate_ranges
    from attentiondm_tpu_torch.quant.int8_serving import prepare_serving_runtime, runtime_nbytes
    from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

    settings = settings or {"f32 core": F32_CORE}
    R, shape = cfg.resolution, (batch, cfg.resolution, cfg.resolution, cfg.out_ch)
    params = unet_init(gen, cfg, dev)
    print(f"[slice] {label}: {R}^2, {count_params(params) / 1e6:.2f}M params, W4A8, {steps} quad steps, "
          f"batch {batch}")
    betas = sched.betas.to(dev)
    seq = make_timestep_seq(1000, steps, "quad")
    x_small = torch.randn((2, R, R, cfg.in_channels), generator=gen).to(dev)
    checks.reset_launches()
    _, traj, _ = clock("FP teacher trajectory (2 images)", lambda: ddim_sample(
        lambda xt, t, i: unet_apply(params, cfg, xt, t), x_small, seq, betas, keep_trajectory=True))
    k11_sites = len(checks.attention_plan(cfg, **F32_CORE)["K11"])  # the FP UNet's long maps are the serving path's
    if flash_attention.launches != steps * k11_sites:
        raise AssertionError(f"FP teacher: K11 launched {flash_attention.launches} times, expected {steps * k11_sites}")
    if k11_sites:
        print(f"[slice] FP teacher: K11 launched {flash_attention.launches} times ({k11_sites} sites a forward)")
    xs_in = torch.cat([x_small[None], traj[:-1]])
    xs_full = torch.cat([x_small[None], traj])
    qunet = QuantizedUNet.create(cfg, 4, 8)
    qstates, attn_ranges = clock("stage-1 calibration", lambda: calibrate_ranges(
        qunet, params, qunet.init_state(steps, dev), xs_in, seq, return_attn_ranges=True))
    del traj
    runtime = clock("per-step fold", lambda: prepare_serving_runtime(qunet, params, qstates))
    weights = sum(lay.gqt.numel() for lay in runtime.values())
    print(f"[slice] fold size: {runtime_nbytes(runtime) / 1e9:.3f} GB for {steps} steps, {weights / 1e9:.3f} GB of it "
          f"the int8 weights, held once (K-major; the fold layout is a view); attention ranges of "
          f"{len(attn_ranges)} projections")
    x = torch.randn(shape, generator=gen).to(dev)
    # xs_in, the calibration trajectory's model inputs, is the weights phase's calibration set
    ctx = dict(cfg=cfg, params=params, qunet=qunet, qstates=qstates, runtime=runtime, seq=seq, betas=betas,
               xs_in=xs_in, xs_full=xs_full, x=x, steps=steps, batch=batch, dev=dev)

    counts, outs = {}, {}
    for name, flags in settings.items():
        if flags.get("attn_ranges"):
            flags = {**flags, "attn_ranges": attn_ranges}
        sample, out, counts[name] = run_sampler(ctx, name, flags)  # the main path, counted
        outs[name] = ctx["out"] = out

        best = min(time_ms(lambda: sample(x), reps=1) for _ in range(2))
        print(f"[slice] serving sampler, {name}: {best:.1f} ms for {steps} steps at batch {batch} = "
              f"{batch / best * 1e3:.2f} images/s ({best / steps:.2f} ms/step; information only); "
              f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
        if profile:
            DEFERRED_PROFILES.append((f"{label}, {name}", lambda sample=sample: sample(x), best))
    ref = outs.get("f32 core")
    for name, out in outs.items():
        if ref is not None and out is not ref:
            print(f"[slice] sampler output, {name} vs f32 core: mean rel difference "
                  f"{((out - ref).abs().mean() / ref.abs().mean()).item():.3e} (information only; random weights)")
    return counts, ctx


def run_sampler(ctx, label, flags, tag="slice", **over):
    """The path's main path under `flags` (attention flags and levers): its
    serving sampler on the context's fold and states (`over` replaces any
    of the context's keys, e.g. `runtime`, `qstates`; `ctx["serve"]`'s
    stage-3 flags go along), run once with every launch count set to 0 just
    before and read just after, the counts held to `expected_launches` and
    the output to a finite tensor of the input's shape; then `step_checks`.
    Returns (sample, out, counts)."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    c = {**ctx, **over}
    steps, batch, x = c["steps"], c["batch"], c["x"]
    flags = {"residual_dtype": torch.bfloat16, **flags}  # bench.py's stream unless the flags name one
    sample = serving_ddim_sampler(c["qunet"], c["params"], c["qstates"], c["seq"], c["betas"], runtime=c["runtime"],
                                  **flags, **c.get("serve", {}))
    expected = checks.expected_launches(c["cfg"], steps, batch, **flags)
    checks.reset_launches()
    out = clock(f"serving sampler, {label}, first run ({steps} steps, batch {batch})", lambda: sample(x), tag)
    counts = checks.read_launches()
    print(f"[{tag}] {label}: launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"{label}: launch counts {counts} != expected {expected}")
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: sampler output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    step_checks(c, flags, tag)
    return sample, out, counts


def step_checks(ctx, levers, tag="slice"):
    """One serving step under `levers` (and attention flags, the residual
    dtype (bf16 unless named), and `ctx["serve"]`'s
    stage-3 states where the path has them): every kernel call held against its
    plain version on the same inputs, then the whole step through the kernels
    against the whole step through the plain versions.  Returns the step's
    launch counts."""
    import torch

    from attentiondm_tpu_torch.quant.int8_serving import serving_unet_apply

    t0 = torch.full((ctx["batch"],), float(ctx["seq"][-1]), device=ctx["dev"])
    flags = {"residual_dtype": torch.bfloat16, **levers}

    def step(plain):
        return serving_unet_apply(ctx["params"], ctx["cfg"], ctx["qunet"], ctx["runtime"], ctx["qstates"],
                                  ctx["x"], t0, 0, plain=plain, **flags, **ctx.get("serve", {}))

    return held_step(step, tag)


def held_step(step, tag):
    """`step(plain)` once through the kernels with every kernel call held
    against its plain version on the same inputs (`ops.checks.per_site`),
    then the whole step through the kernels against the whole step through
    the plain versions (< CHAINED_BOUND).  Returns the step's launch counts."""
    import torch

    from attentiondm_tpu_torch.ops import checks

    records = []
    checks.reset_launches()
    with checks.per_site(records):
        eps = clock("one serving step, per-site check", lambda: step(False), tag)
    counts = checks.read_launches()
    by_kind = collections.defaultdict(list)
    for kind, oshape, f in records:
        by_kind[kind].append((oshape, f))
    for kind, rows in by_kind.items():
        worst = max(rows, key=lambda r: (not r[1]["ok"], r[1]["max_abs_err"]))
        print(f"[{tag}] per-site {kind}: {len(rows)} sites, {sum(r[1]['ok'] for r in rows)} within tolerance; "
              f"worst {worst[0]}: {_fig(worst[1])}")
    bad = [r for r in records if not r[2]["ok"]]
    if bad:
        raise AssertionError(f"per-site kernels vs plain: {len(bad)} sites off tolerance: {bad[:5]}")

    # the same step, chained: through the kernels vs through the plain versions
    eps_p = step(True)
    rel = ((eps - eps_p).abs().mean() / eps_p.abs().mean()).item()
    print(f"[{tag}] one serving step chained, kernels vs plain versions: mean rel err {rel:.3e} "
          f"(bit-identical: {torch.equal(eps, eps_p)}; gross-fault bound {CHAINED_BOUND})")
    if not rel < CHAINED_BOUND:
        raise AssertionError(f"serving step kernels vs plain: mean rel err {rel}")
    return counts


def levers_phase(ctx, timed, profile=False):
    """The same params, calibration and fold under the three levers.  With
    `timed` (CIFAR-10): the sampler with all three, counted and checked, the
    per-site and chained step, and timed runs in turns of levers off, all
    three and each lever alone.  Without (church): the per-site and chained
    step, launch counts checked.  Returns the counted run's launch counts."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg, steps, batch, x = ctx["cfg"], ctx["steps"], ctx["batch"], ctx["x"]
    plan = checks.lever_plan(cfg, batch, **ALL_LEVERS)
    print(f"[levers] {ALL_LEVERS}: per step K4 at {len(plan['K4'])} entries, K7 at "
          f"{[site for site, *_ in plan['K7']]}, K12 at {[site for site, *_ in plan['K12']]}")
    if not timed:
        expected = checks.expected_launches(cfg, 1, batch, **F32_CORE, **ALL_LEVERS)
        counts = step_checks(ctx, {**F32_CORE, **ALL_LEVERS}, "levers")
        print(f"[levers] launches of the step {counts}, expected {expected}")
        if counts != expected:
            raise AssertionError(f"lever step launch counts {counts} != expected {expected}")
        return counts

    def sampler(levers):
        return serving_ddim_sampler(ctx["qunet"], ctx["params"], ctx["qstates"], ctx["seq"], ctx["betas"],
                                    runtime=ctx["runtime"], residual_dtype=torch.bfloat16, **F32_CORE, **levers)

    sample, out, counts = run_sampler(ctx, "the three levers", {**F32_CORE, **ALL_LEVERS}, "levers")
    off = sampler({})(x)
    rel = ((out - off).abs().mean() / off.abs().mean()).item()
    print(f"[levers] sampler output, three levers vs levers off: mean rel err {rel:.3e} (information only: the "
          f"levers change the GroupNorm statistics' formula and where bf16 rounds)")
    del out, off

    # timed runs in turns (levers off, all three, each lever alone), LEVER_ROUNDS rounds: the host's ~1000
    # launches a step set these times as much as the card does, and the host's clock varies, so every run is shown
    fns = {name: sampler(levers) for name, levers in [("levers off", {}), *LEVER_SETS.items()]}
    for fn in fns.values():
        fn(x)  # warm-up
    runs = {name: [] for name in fns}
    for _ in range(LEVER_ROUNDS):
        for name, fn in fns.items():
            runs[name].append(time_ms(lambda: fn(x), reps=1, warm=False))
    times = {}
    for name, levers in [("levers off", {}), *LEVER_SETS.items()]:
        ms = times[name] = sorted(runs[name])[LEVER_ROUNDS // 2]
        per = checks.expected_launches(cfg, 1, batch, **F32_CORE, **levers)
        print(f"[levers] serving sampler, {name}: median {ms:.1f} ms for {steps} steps at batch {batch} = "
              f"{batch / ms * 1e3:.2f} images/s ({ms / steps:.2f} ms/step; best {min(runs[name]):.1f} ms; runs "
              f"{' '.join(f'{t:.1f}' for t in runs[name])}; launches per step "
              f"K1 {per['K1']} K2 {per['K2']} K3 {per['K3']} K4 {per['K4']} K7 {per['K7']} K12 {per['K12']})")
    if profile:
        DEFERRED_PROFILES.append((f"batch {batch}, the three levers", lambda: sample(x), times["all three"]))
    return counts


def fold_forms_phase(ctx):
    """The sampler's fold forms on the path's params, calibration and input:
    `step_chunk=2` with half-batch micro-batches, `pack_int4`, and both,
    each launch-counted and held bit-equal to the unchunked, unpacked
    sampler's output; then `rank1`, held by the per-site and chained step on
    its own fold.  Prints each fold's size (a chunk's for the chunked forms)."""
    import torch

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_serving import (
        prepare_serving_runtime,
        runtime_nbytes,
        serving_ddim_sampler,
    )

    cfg, steps, batch, x, ref = ctx["cfg"], ctx["steps"], ctx["batch"], ctx["x"], ctx["out"]
    args = (ctx["qunet"], ctx["params"], ctx["qstates"], ctx["seq"], ctx["betas"])
    full = runtime_nbytes(ctx["runtime"])
    print(f"[folds] unchunked, unpacked fold: {full / 1e9:.3f} GB for {steps} steps "
          f"({full / steps * 100 / 1e9:.2f} GB at 100 steps)")
    mb = batch // 2
    forms = {f"step_chunk=2, micro_batch={mb}": dict(step_chunk=2, micro_batch=mb), "pack_int4": dict(pack_int4=True),
             f"step_chunk=2, micro_batch={mb}, pack_int4": dict(step_chunk=2, micro_batch=mb, pack_int4=True)}
    for name, kw in forms.items():
        sample = serving_ddim_sampler(*args, residual_dtype=torch.bfloat16, **F32_CORE, **kw)
        if "step_chunk" in kw:  # one chunk's fold, the most a chunked run holds at once
            chunk = prepare_serving_runtime(*args[:3], steps=slice(0, 2), pack_int4=kw.get("pack_int4", False))
            nb = runtime_nbytes(chunk)
            del chunk
            size = f"{nb / 1e9:.3f} GB a chunk of 2 steps (at most {nb / 1e9:.3f} GB at any schedule length)"
        else:  # the packed codes grow with the steps, the one unpacked step does not
            nb, buf = runtime_nbytes(sample.runtime), nbytes(sample.runtime.unpacked)
            size = (f"{nb / 1e9:.3f} GB for {steps} steps, {buf / 1e9:.3f} GB of it one unpacked step "
                    f"({((nb - buf) / steps * 100 + buf) / 1e9:.2f} GB at 100 steps)")
        torch.cuda.reset_peak_memory_stats()
        per_call = kw.get("micro_batch", batch)  # each micro-batch runs every step
        expected = checks.expected_launches(cfg, steps * batch // per_call, per_call, **F32_CORE)
        checks.reset_launches()
        out = clock(f"serving sampler, {name} ({steps} steps, batch {batch})", lambda: sample(x), "folds")
        counts = checks.read_launches()
        if counts != expected:
            raise AssertionError(f"{name}: launch counts {counts} != expected {expected}")
        diff = (out - ref).abs()
        print(f"[folds] {name}: fold {size}; launches as expected; bit-equal to the unchunked, unpacked sampler: "
              f"{torch.equal(out, ref)} (max abs difference {diff.max().item():.3e}, {int((diff > 0).sum())} of "
              f"{diff.numel()} values differ); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        if not torch.equal(out, ref):
            per_image = (diff.reshape(batch, -1) > 0).any(dim=1).nonzero().flatten().tolist()
            raise AssertionError(f"{name}: the sampler's output differs from the unchunked one (images {per_image})")
        del sample, out

    sample = serving_ddim_sampler(*args, residual_dtype=torch.bfloat16, **F32_CORE, rank1=True)
    nb = runtime_nbytes(sample.runtime)
    expected = checks.expected_launches(cfg, steps, batch, **F32_CORE)
    checks.reset_launches()
    out = clock(f"serving sampler, rank1 ({steps} steps, batch {batch})", lambda: sample(x), "folds")
    counts = checks.read_launches()
    if counts != expected:
        raise AssertionError(f"rank1: launch counts {counts} != expected {expected}")
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"rank1 sampler output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    rel = ((out - ref).abs().mean() / ref.abs().mean()).item()
    print(f"[folds] rank1: fold {nb / 1e9:.3f} GB for {steps} steps (the int8 weights held once: about the same at "
          f"100 steps); launches as expected; mean rel difference from the per-step fold's sample {rel:.3e} "
          f"(information only: rank-1 scales are another quantization)")
    step_checks({**ctx, "runtime": sample.runtime}, F32_CORE, "folds")
    del sample, out
    torch.cuda.empty_cache()


WEIGHT_METHODS = {  # compute_weight_extras' settings of the runner's --weight_opt values
    "adaround": dict(iters=1000), "gptq": dict(method="gptq"), "biascorr": dict(adaround_max_wbit=0)}
REFINE_EPOCHS, REFINE_INNER = 2, 4  # the refinement's passes: shared mode epochs, per-step Adam iterations
# the surrogate's convs against the served fold's on the same inputs (mean relative; float32 order only)
SURROGATE_SITE_BOUND = 1e-4


def weights_phase(ctx):
    """The W4 weight-quality pass on the path's params, calibration and
    input, all on the card: the Gram collection over 8 of the calibration
    trajectory's steps, then AdaRound (1000 Adam steps), GPTQ and bias
    correction alone (timed; the Gram objectives of AdaRound's and GPTQ's
    offsets summed over the layers must be below round-to-nearest's), the
    refinement of AdaRound's extras in the shared mode and per step (each
    never worse than its init on the surrogate's objective), and each set of
    extras folded and served through the kernels with the levers off and
    all three on (launch counts, every site of a step teacher-forced, a
    finite output; the per-step refined extras chunked by 5 steps bit-equal
    to the unchunked sampler).  Then the surrogate against the served fold,
    conv by conv and the whole step, and the fake-quant model's sample (information lines: how far each
    served sample lies from it and from the FP teacher's)."""
    import torch

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
    from attentiondm_tpu_torch.models.unet import lookup, unet_apply
    from attentiondm_tpu_torch.quant import adaround as ar
    from attentiondm_tpu_torch.ops.fused_gn import quant_i8
    from attentiondm_tpu_torch.quant.calibrate import (
        refine_weight_extras,
        serving_surrogate_apply,
        surrogate_conv_apply,
    )
    from attentiondm_tpu_torch.quant.int8_runtime import _step_ranges
    from attentiondm_tpu_torch.quant.int8_serving import (
        _epilogue,
        gather_step,
        int8_conv,
        int8_conv3_qzero,
        prepare_serving_runtime,
        runtime_nbytes,
        serving_ddim_sampler,
        serving_unet_apply,
    )

    cfg, params, qunet, qstates, seq, betas = (ctx[k] for k in ("cfg", "params", "qunet", "qstates", "seq", "betas"))
    x, xs_in, steps, batch, dev = (ctx[k] for k in ("x", "xs_in", "steps", "batch", "dev"))
    S = xs_in.shape[0]
    stats = clock(f"Gram collection: {min(8, S)} of the {S} calibration steps, {xs_in.shape[1]} images",
                  lambda: ar.collect_weight_stats(qunet, params, qstates, xs_in, seq, max_steps=8), "weights")
    grams = {n: st for n, st in stats.items() if st.gram.shape[0] > 1}
    print(f"[weights] Grams of {len(grams)} layers (K {min(st.gram.shape[0] for st in grams.values())} to "
          f"{max(st.gram.shape[0] for st in grams.values())}): {sum(st.gram.numel() for st in grams.values()) * 4 / 1e9:.3f} "
          f"GB of float32")
    extras = {}
    for method, kw in WEIGHT_METHODS.items():
        extras[method] = clock(f"{method} ({kw})", lambda: ar.compute_weight_extras(
            qunet, params, qstates, xs_in, seq, max_steps=8, stats=stats, **kw), "weights")
    for method, ex in extras.items():
        off_device = [n for n, e in ex.items() for t in (e.round_offset, e.mu, e.shrink) if t is not None and
                      t.device != dev]
        if off_device:
            raise AssertionError(f"{method}: extras of {off_device[:3]} are not on {dev}")

    # the Gram objective each method lowers, against round-to-nearest on the same grid
    for method in ("adaround", "gptq"):
        ratios, total, rtn = [], 0.0, 0.0
        for n, e in extras[method].items():
            if e.round_offset is None:
                continue
            kernel, st, pol = lookup(params, n)["kernel"], qstates[n], qunet.policy[n]
            scale = _step_ranges(st.group_ranges, st.alpha_logits, pol.a_bit)[0].mean(dim=0)
            em = float(ar.gram_objective(kernel, scale, stats[n], pol.w_bit, e.shrink, e.round_offset))
            er = float(ar.gram_objective(kernel, scale, stats[n], pol.w_bit, e.shrink))
            total, rtn = total + em, rtn + er
            ratios.append(em / er)
        ratios.sort()
        offs = torch.cat([e.round_offset.flatten() for e in extras[method].values() if e.round_offset is not None])
        print(f"[weights] {method}: offsets on {len(ratios)} layers (values {int(offs.min())} to {int(offs.max())}); "
              f"Gram objective / round-to-nearest's per layer min {ratios[0]:.4f} median {ratios[len(ratios) // 2]:.4f} "
              f"max {ratios[-1]:.4f}; summed over the layers {total:.6g} against {rtn:.6g} ({total / rtn:.4f})")
        if not total < rtn:
            raise AssertionError(f"{method}: summed Gram objective {total} not below round-to-nearest's {rtn}")
    print(f"[weights] biascorr: means of {sum(e.mu is not None for e in extras['biascorr'].values())} layers, "
          f"no offsets ({sum(e.round_offset is not None for e in extras['biascorr'].values())})")

    # the refinement of AdaRound's extras against the FP teacher's eps on its own trajectory
    t_rev = [float(t) for t in reversed(list(seq))]
    with torch.no_grad():
        eps_ref = torch.stack([unet_apply(params, cfg, xs_in[i], torch.full((xs_in.shape[1],), t_rev[i], device=dev))
                               for i in range(S)])
    ctx.update(eps_ref=eps_ref, gptq=extras["gptq"])  # for the stage2 phase

    def surrogate_loss(ex):
        with torch.no_grad():
            out = [serving_surrogate_apply(qunet, params, qstates, ex, xs_in[i],
                                           torch.full((xs_in.shape[1],), t_rev[i], device=dev), i) for i in range(S)]
        return float(torch.stack([torch.mean(torch.square(o - e)) / torch.mean(torch.square(e))
                                  for o, e in zip(out, eps_ref)]).mean())

    init = surrogate_loss(extras["adaround"])
    for name, kw in (("shared", dict(epochs=REFINE_EPOCHS)), ("per_step", dict(per_step=True, inner=REFINE_INNER))):
        refined, trace = clock(f"refine_weight_extras, {name} ({kw})", lambda: refine_weight_extras(
            qunet, params, qstates, extras["adaround"], xs_in, eps_ref, seq, **kw), "weights")
        loss = surrogate_loss(refined)
        print(f"[weights] refined ({name}): surrogate objective {loss:.6g} against the init's {init:.6g}; losses "
              f"{[round(float(v), 6) for v in torch.as_tensor(trace).flatten()]}")
        if not loss <= init:
            raise AssertionError(f"refine ({name}): objective {loss} above the init's {init}")
        extras[f"refined {name}"] = refined

    # each set of extras folded and served through the kernels
    t0 = torch.full((batch,), float(seq[-1]), device=dev)
    outs, runtimes = {}, {}
    for name, ex in extras.items():
        rt = runtimes[name] = clock(f"fold with the {name} extras", lambda: prepare_serving_runtime(
            qunet, params, qstates, weight_extras=ex), "weights")
        for label, levers in (("levers off", {}), ("three levers", ALL_LEVERS)):
            _, out, _ = run_sampler(ctx, f"{name} extras, {label}", {**F32_CORE, **levers}, "weights", runtime=rt)
            if not levers:
                outs[name] = out
        print(f"[weights] {name} extras: fold {runtime_nbytes(rt) / 1e9:.3f} GB; launches as expected with the levers "
              f"off and all three on; every site within tolerance")
    chunked = serving_ddim_sampler(qunet, params, qstates, seq, betas, step_chunk=5, weight_extras=extras[
        "refined per_step"], residual_dtype=torch.bfloat16, **F32_CORE)(x)
    same = torch.equal(chunked, outs["refined per_step"])
    print(f"[weights] refined per_step extras, step_chunk=5: bit-equal to the unchunked sampler: {same}")
    if not same:
        raise AssertionError("per-step refined extras: the chunked sampler differs from the unchunked one")

    # the surrogate against the served fold, step 0, AdaRound's extras: every stride-1 folded conv of a
    # surrogate forward given its input, through K1 (int32) and the fold's epilogue; then the whole step
    rt_0 = gather_step(runtimes["adaround"], 0)
    sites, n = [], min(8, batch)
    ca = surrogate_conv_apply(qunet, qstates, extras["adaround"], 0)

    def recording(name, xin, p, *, stride=1, padding="SAME"):
        out = ca(name, xin, p, stride=stride, padding=padding)
        if name in rt_0 and stride == 1:
            sites.append((name, xin, out))
        return out

    with torch.no_grad():
        unet_apply(params, cfg, x[:n], t0[:n], conv_apply=recording)
        worst = (0.0, None)
        for name, xin, want in sites:
            lay, a_bit, co = rt_0[name], qunet.policy[name].a_bit, lookup(params, name)["kernel"].shape[3]
            xq = quant_i8(xin, lay.act_scale, lay.act_zp, a_bit)
            dot = (int8_conv3_qzero(xq, lay.act_zp, a_bit, lay.gq, gqt=lay.gqt) if lookup(params, name)["kernel"]
                   .shape[0] == 3 else int8_conv(xq, lay.gq, 1, gqt=lay.gqt))
            rel = ((_epilogue(dot, lay, co) - want).abs().mean() / want.abs().mean()).item()
            worst = max(worst, (rel, name), key=lambda w: w[0])
        print(f"[weights] serving_surrogate_apply's convs vs the served fold (K1, int32, and the epilogue) on the "
              f"surrogate's inputs, step 0, AdaRound's extras, batch {n}: {len(sites)} sites, worst mean rel "
              f"difference {worst[0]:.3e} at {worst[1]} (bound {SURROGATE_SITE_BOUND})")
        if not worst[0] < SURROGATE_SITE_BOUND:
            raise AssertionError(f"surrogate conv {worst[1]} vs the served fold: mean rel difference {worst[0]}")
        srv = serving_unet_apply(params, cfg, qunet, runtimes["adaround"], qstates, x, t0, 0,
                                 residual_dtype=torch.bfloat16, **F32_CORE)
        sur = serving_surrogate_apply(qunet, params, qstates, extras["adaround"], x, t0, 0)
    rel = ((sur - srv).abs().mean() / srv.abs().mean()).item()
    # JAX's tests/test_serving_surrogate.py holds this at 0.02 on its one-level 2-step toy; JAX's own pair
    # measures 0.051 on a two-level 10-step toy (CPU), so at full width it is held to the chained bound
    print(f"[weights] serving_surrogate_apply vs the serving step (step 0, AdaRound's extras, batch {batch}): mean "
          f"rel difference {rel:.3e} (gross-fault bound {CHAINED_BOUND}: the site check above is the exact one)")
    if not rel < CHAINED_BOUND:
        raise AssertionError(f"surrogate vs serving step: mean rel difference {rel}")
    del runtimes, srv, sur, sites

    # the fake-quant W4A8 model and the FP teacher on the same x
    qparams, _ws = qunet.prepare_params(params)
    fq = clock(f"fake-quant model (QuantizedUNet.model_fn, mode infer), DDIM {steps} steps", lambda: ddim_sample(
        qunet.model_fn(qparams, qstates), x, seq, betas), "weights")
    if tuple(fq.shape) != tuple(x.shape) or not bool(torch.isfinite(fq).all()):
        raise AssertionError(f"fake-quant sample {tuple(fq.shape)}, finite={bool(torch.isfinite(fq).all())}")
    fp = ctx["fp"] = ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x, seq, betas)
    outs = {"round-to-nearest": ctx["out"], **outs}
    for name, out in outs.items():
        print(f"[weights] sample, {name} fold: mean rel difference from the fake-quant sample "
              f"{((out - fq).abs().mean() / fq.abs().mean()).item():.4e}, from the FP teacher's "
              f"{((out - fp).abs().mean() / fp.abs().mean()).item():.4e} (information only: random weights)")
    print(f"[weights] fake-quant sample from the FP teacher's: {((fq - fp).abs().mean() / fp.abs().mean()).item():.4e}")
    torch.cuda.empty_cache()


STAGE2_LR, STAGE2_EPOCHS = 0.02, 4  # the runner's --stage2_lr and teacher-matched passes (calib_epochs * 4)
ATTN_LOSS_WEIGHT = 0.5  # the runner's --attention_loss_weight, the attention-focused stage 2's entropy weight
BEST_ITERATE_SLACK = 1e-6  # a re-evaluated objective may differ from the run's in the last bits


def served(ctx, qstates, label, tag, weight_extras=None):
    """`qstates` (and `weight_extras`) folded and served through the kernels
    with the levers off (`run_sampler`).  Returns the sample."""
    from attentiondm_tpu_torch.quant.int8_serving import prepare_serving_runtime

    rt = clock("fold", lambda: prepare_serving_runtime(ctx["qunet"], ctx["params"], qstates,
                                                       weight_extras=weight_extras), tag)
    return run_sampler(ctx, label, F32_CORE, tag, runtime=rt, qstates=qstates)[1]


def stage2_phase(ctx):
    """Stage 2 on the CIFAR-10 path's params, calibration, trajectory, FP
    teacher eps and GPTQ extras (`weights_phase`), on the card: the
    attention-focused differentiable group selection (one epoch, fresh noise
    from a seeded generator, on the "real" calibration images), and the
    teacher-matched stage 2 on the weight-quantized params and through the
    serving surrogate with the GPTQ extras.  Each run's seconds and first /
    last losses; each teacher-matched run's objective re-evaluated on its
    result at every step, which must be at or below the stage-1 init's (the
    first pass's loss at that step); each result folded and served through
    the kernels (`served`), its sample's distance from the FP teacher's."""
    import torch

    from attentiondm_tpu_torch.quant.calibrate import (
        _teacher_matched_loss,
        calibrate_differentiable,
        calibrate_teacher_matched,
        select_calibration_images,
    )

    params, qunet, qstates, seq, betas = (ctx[k] for k in ("params", "qunet", "qstates", "seq", "betas"))
    xs_in, eps_ref, dev, fp = ctx["xs_in"], ctx["eps_ref"], ctx["dev"], ctx["fp"]
    S = xs_in.shape[0]
    t_rev = [float(t) for t in reversed(list(seq))]
    imgs, _, _ = select_calibration_images(ctx["xs_full"], "real", num_steps=S)
    gen = torch.Generator(device=dev).manual_seed(99)
    results = {}
    qs, losses = clock(f"calibrate_differentiable (attention_focus, 1 epoch, {imgs.shape[0]} images, {S} steps)",
                       lambda: calibrate_differentiable(qunet, params, qstates, imgs, seq, betas, generator=gen,
                                                        diff_loss_weight=ATTN_LOSS_WEIGHT, attention_focus=True),
                       "stage2")
    print(f"[stage2] differentiable: {len(losses)} optimizer steps, loss at the first / last step {losses[0]:.4f} / "
          f"{losses[-1]:.4f} (per-step losses are not comparable across timesteps)")
    results["differentiable"] = (qs, None)
    qparams, _ = qunet.prepare_params(params)
    for name, fwd, extras in (("teacher-matched", qparams, None), ("teacher-matched, GPTQ surrogate", params,
                                                                    ctx["gptq"])):
        qs, losses = clock(f"calibrate_teacher_matched ({name}, lr {STAGE2_LR}, {STAGE2_EPOCHS} passes, "
                           f"{xs_in.shape[1]} images, {S} steps)", lambda: calibrate_teacher_matched(
                               qunet, fwd, qstates, xs_in, eps_ref, seq, lr=STAGE2_LR, epochs=STAGE2_EPOCHS,
                               serving_extras=extras), "stage2")
        init = losses[:S]
        with torch.no_grad():
            best = [float(_teacher_matched_loss(qunet, fwd, qs, {}, xs_in[s], eps_ref[s], t_rev[s], s,
                                                serving_extras=extras)) for s in range(S)]
        run_min = [min(losses[s::S]) for s in range(S)]
        print(f"[stage2] {name}: rel-eps objective, init (stage 1) mean {sum(init) / S:.6g}, best mean "
              f"{sum(best) / S:.6g}; per step init {[round(v, 6) for v in init]} best {[round(v, 6) for v in best]}; "
              f"first / last loss {losses[0]:.6g} / {losses[-1]:.6g}")
        worse = [s for s in range(S) if not best[s] <= init[s] * (1 + BEST_ITERATE_SLACK)]
        off = [s for s in range(S) if abs(best[s] - run_min[s]) > BEST_ITERATE_SLACK * run_min[s]]
        if worse or off:
            raise AssertionError(f"{name}: steps {worse} above their stage-1 init, steps {off} not the run's best")
        results[name] = (qs, extras)
    for name, (qs, extras) in results.items():
        out = served(ctx, qs, name, "stage2", weight_extras=extras)
        print(f"[stage2] {name}: served through the kernels, launches as expected, every site within tolerance; "
              f"sample's mean rel difference from the FP teacher's {((out - fp).abs().mean() / fp.abs().mean()).item():.4e} "
              f"(round-to-nearest stage 1: {((ctx['out'] - fp).abs().mean() / fp.abs().mean()).item():.4e}; "
              f"information only: random weights)")
    torch.cuda.empty_cache()


CAL_IMAGES = 16  # the runner's calibration set (generate_calibrate_set: min(num_calibrate_set, 16))
MP_BASE_BITS = 4  # W4A8's --bitwidth: effective bits 4 + 2 sigmoid(0.5) = 5.25, so the logits quantize at 5 bits
MP_PROBES = (0, 250, 500, 750, 999)  # the runner's stage-3 probe timesteps


def enhanced_slice_phase(cfg, sched, label, steps, batch, gen, dev, profile=False):
    """The enhanced path's calibration and sampler (the runner's
    `--attn_variant enhanced --calibrate_attention --mixed_precision_attention`
    flow) on the card: FP teacher on `CAL_IMAGES` images, stage 1, the
    calibration set by t-mode "diff", the attention-focused stage 2, stage 3,
    the fold, then the sampler with the stage-3 core and without it.
    Returns the launch counts of each, and the context (its `serve` the MP
    core's flags)."""
    import torch

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, make_timestep_seq
    from attentiondm_tpu_torch.models.unet import count_params, lookup, unet_apply, unet_init
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.attention_mp import (
        calibrate_mp_attention,
        init_mp_attention_state,
        make_logit_collector,
    )
    from attentiondm_tpu_torch.quant.calibrate import (
        calibrate_differentiable,
        calibrate_ranges,
        select_calibration_images,
    )
    from attentiondm_tpu_torch.quant.int8_serving import prepare_serving_runtime
    from attentiondm_tpu_torch.quant.qunet import QuantizedUNet, make_quant_conv_apply

    R, shape = cfg.resolution, (batch, cfg.resolution, cfg.resolution, cfg.out_ch)
    params = unet_init(gen, cfg, dev)
    sites = [site for site, _L, _C in checks.attention_sites(cfg)]
    for site in sites:  # JAX's init of 0 makes every block the identity
        lookup(params, site)["gamma"].fill_(0.5 + float(torch.rand(1, generator=gen)))
    print(f"[slice] {label}: {R}^2, {count_params(params) / 1e6:.2f}M params, W4A8, {steps} quad steps, batch {batch}; "
          f"enhanced attention at {len(sites)} sites (C = {checks.attention_sites(cfg)[0][2]}, Ck = "
          f"{lookup(params, sites[0])['query_conv']['kernel'].shape[3]}, {cfg.attn_heads} heads), gammas "
          f"{[round(float(lookup(params, s)['gamma']), 3) for s in sites]}")
    betas = sched.betas.to(dev)
    seq = make_timestep_seq(1000, steps, "quad")
    x_cal = torch.randn((CAL_IMAGES, R, R, cfg.in_channels), generator=gen).to(dev)
    checks.reset_launches()
    _, traj, _ = clock(f"FP teacher trajectory ({CAL_IMAGES} images)", lambda: ddim_sample(
        lambda xt, t, i: unet_apply(params, cfg, xt, t), x_cal, seq, betas, keep_trajectory=True))
    if any(checks.read_launches().values()):
        raise AssertionError(f"FP teacher of the enhanced model launched kernels: {checks.read_launches()}")
    xs_full = torch.cat([x_cal[None], traj])
    xs_in = xs_full[:-1]
    qunet = QuantizedUNet.create(cfg, 4, 8)
    qstates = clock("stage-1 calibration", lambda: calibrate_ranges(qunet, params, qunet.init_state(steps, dev), xs_in,
                                                                     seq))
    imgs, t_sel, _count = select_calibration_images(xs_full, "diff", num_steps=steps, qstates=qstates)
    print(f"[slice] calibration set by t-mode \"diff\": step {int(t_sel)} of {steps} (the last argmax of the alpha "
          f"uncertainty from min_t {min(30, steps - 1)} on), {imgs.shape[0]} images")
    qstates, losses = clock(f"stage 2: calibrate_differentiable (attention_focus, 1 epoch, {imgs.shape[0]} images)",
                            lambda: calibrate_differentiable(qunet, params, qstates, imgs, seq, betas,
                                                             generator=torch.Generator(device=dev).manual_seed(99),
                                                             diff_loss_weight=ATTN_LOSS_WEIGHT, attention_focus=True))
    print(f"[slice] stage 2: {len(losses)} optimizer steps, loss at the first / last step {losses[0]:.4f} / "
          f"{losses[-1]:.4f}")

    def stage3():
        collector = make_logit_collector(params, cfg, imgs)
        states = {n: init_mp_attention_state(1000, dev) for n in sites}
        return calibrate_mp_attention(collector, states, base_bits=MP_BASE_BITS, timesteps=MP_PROBES)

    mp_states = clock(f"stage 3: calibrate_mp_attention ({len(MP_PROBES)} probe forwards)", stage3)
    print("[slice] stage 3: logit ranges " + ", ".join(
        f"{n} scale {float(st.scale_qk):.4g} zero {float(st.zero_qk):.4g}" for n, st in mp_states.items()))
    runtime = clock("per-step fold", lambda: prepare_serving_runtime(qunet, params, qstates))
    x = torch.randn(shape, generator=gen).to(dev)
    serve = dict(mp_states=mp_states, mp_base_bits=MP_BASE_BITS)
    ctx = dict(cfg=cfg, params=params, qunet=qunet, qstates=qstates, runtime=runtime, seq=seq, betas=betas,
               xs_in=xs_in, x=x, steps=steps, batch=batch, dev=dev)
    counts, outs = {}, {}
    for name, kw in (("f32 core", {}), ("mp core", serve)):
        sample, outs[name], counts[name] = run_sampler(ctx, name, F32_CORE, serve=kw)  # the main path, counted
        best = min(time_ms(lambda: sample(x), reps=1) for _ in range(2))
        dms = graph_ms(lambda: sample(x))
        print(f"[slice] serving sampler, {name}: {best:.1f} ms wall for {steps} steps at batch {batch} = "
              f"{batch / best * 1e3:.2f} images/s ({best / steps:.2f} ms/step); device {dms:.1f} ms = "
              f"{dms / steps:.2f} ms/step (one run replayed as a CUDA graph; the sampler itself runs eagerly, so "
              f"{batch / dms * 1e3:.2f} images/s is the card's bound, not a rate it delivers); peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
        if profile:
            DEFERRED_PROFILES.append((f"{label}, {name}", lambda sample=sample: sample(x), best))
    mp_out, plain = outs["mp core"], outs["f32 core"]
    if torch.equal(mp_out, plain):
        raise AssertionError("the stage-3 core left the enhanced sample unchanged")
    qparams, _ = qunet.prepare_params(params)

    def fake_quant(xt, t, i):
        ctx_ = {"mp_states": mp_states, "base_bits": MP_BASE_BITS, "timestep": t[0].to(torch.int64)}
        return unet_apply(qparams, cfg, xt, t, conv_apply=make_quant_conv_apply(qstates, qunet.policy, i, "infer"),
                          attn_ctx=ctx_)

    with torch.no_grad():
        fq = clock(f"fake-quant enhanced model with the stage-3 core, DDIM {steps} steps", lambda: ddim_sample(
            fake_quant, x, seq, betas))
        fp = ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x, seq, betas)

    def rel(a, b):
        return ((a - b).abs().mean() / b.abs().mean()).item()

    print(f"[slice] samples: the MP core's from the f32 core's {rel(mp_out, plain):.4e} (must differ: it does); from "
          f"the fake-quant MP model's {rel(mp_out, fq):.4e}; from the FP teacher's {rel(mp_out, fp):.4e} (f32 core's "
          f"{rel(plain, fp):.4e}, fake-quant MP model's {rel(fq, fp):.4e}; information only: random weights)")
    return counts, {**ctx, "serve": serve}


CLI_EXP = "exp/chip_smoke_cli"  # the CLI's --exp tree (git-ignored), emptied before the path runs
CLI_FID = 256  # --num_samples of the --fid run (two batches of 128)
CLI_HOLE = 130  # the --fid files from this id on are deleted, then the run resumes
SERVING = ["--execution", "serving"]
# the serving runs (a) to (c): (a) writes the calibration cache that (b), (d) and (e)'s fake-quant run load; (c)'s
# eta is part of the cache's header, so it calibrates anew (without the fold refinement) into a cache of its own
CLI_SERVING_RUNS = {"a": SERVING + ["--calib_cache", "auto"],
                    "b": SERVING + ["--calib_cache", "auto", "--sample_type", "ddpm_noisy"],
                    "c": SERVING + ["--calib_cache", f"{CLI_EXP}/calib_eta.npz", "--eta", "0.5",
                                    "--weight_refine", "off"]}
CLI_OTHER_RUNS = {"fake_quant": ["--execution", "fake_quant", "--calib_cache", "auto"], "fp32": ["--fp32"],
                  "fp32 bf16": ["--fp32", "--compute_dtype", "bfloat16"]}


def cli_argv(steps, batch, ckpt, *extra, n=None):
    """main_torch's argv: cifar10.yml at --batch_size `batch`, `n` images (default one batch), `steps` quad steps."""
    return ["--config", "cifar10.yml", "--doc", "cifar10-cli", "--exp", CLI_EXP, "--sample", "--ni", "--batch_size",
            str(batch), "--num_samples", str(n or batch), "--timesteps", str(steps), "--skip_type", "quad",
            "--ckpt_path", ckpt, *extra]


def cli_run(label, argv, tag="cli"):
    """`main_torch.main(argv)` with every launch count set to 0 just before
    and read just after; it must return 0.  Prints the runner's seconds per
    stage.  Returns (runner, launch counts)."""
    import main_torch
    from attentiondm_tpu_torch.ops import checks

    checks.reset_launches()
    t0 = time.perf_counter()
    rc = main_torch.main(argv)
    wall = time.perf_counter() - t0
    counts = checks.read_launches()
    if rc != 0:
        raise AssertionError(f"main_torch.main({argv}) returned {rc} (its traceback is in the log above)")
    r = main_torch.main.runner
    shown = argv[argv.index("--ckpt_path") + 2:] if "--ckpt_path" in argv else argv
    rate = ""
    if r.timings.get("sampling"):
        n = r.fid_images or int(r.args.num_samples)
        rate = f"; sampling {n} images: {n / r.timings['sampling']:.1f} images/s"
    print(f"[{tag}] ({label}) {' '.join(shown)}: {wall:.2f} s; seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in r.timings.items()) + rate)
    return r, counts


def cli_serving_checks(label, r, counts, steps, batch, runs=1, full=True):
    """A serving run's checks: its launch counts against `expected_launches`
    for the flags the runner passed (`runs` sampler runs); with `full`, one
    served step held site by site and chained, the PNGs equal to the
    runner's sampler run again on the same draws, and that run against the
    same sampler through the plain versions on the same generator
    (< CHAINED_BOUND)."""
    import torch

    from attentiondm_tpu_torch.data.transforms import inverse_transform_uint8
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler, serving_unet_apply
    from attentiondm_tpu_torch.utils.images import read_png

    srv, dev = r.serving, r.device
    kw = srv["kwargs"]
    flags = {k: kw[k] for k in ("attn_int8", "attn_ranges", "residual_dtype")}
    expected = {k: v * runs for k, v in checks.expected_launches(r.ucfg, steps, batch, **flags).items()}
    print(f"[cli] ({label}) update {kw['update']}, eta {kw['eta']}, residual {kw['residual_dtype']}, weight extras on "
          f"{len(kw['weight_extras'] or {})} layers: launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"cli ({label}): launch counts {counts} != expected {expected}")
    if not full:
        return
    shape = (batch, r.ucfg.resolution, r.ucfg.resolution, r.ucfg.in_channels)
    x, draws = r.randomness("sample", shape)
    t0 = torch.full((batch,), float(srv["seq"][-1]), device=dev)
    runtime = srv["sampler"].runtime

    def step(plain):
        return serving_unet_apply(srv["params"], r.ucfg, srv["qunet"], runtime, srv["qstates"], x, t0, 0, plain=plain,
                                  **flags)

    held_step(step, "cli")
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    out = srv["sampler"](x, **draws)
    torch.cuda.synchronize()
    print(f"[cli] ({label}) the runner's sampling stage {r.timings['sampling'] * 1e3:.1f} ms (the sampler's first run); "
          f"the same sampler again on the same draws {(time.perf_counter() - t_run) * 1e3:.1f} ms wall")
    want = inverse_transform_uint8(r.config, out).cpu().numpy()
    for i in range(batch):
        if not (read_png(f"{r.args.image_folder}/sample_{i}.png") == want[i]).all():
            raise AssertionError(f"cli ({label}): sample_{i}.png is not the sampler's image {i}")
    x2, draws2 = r.randomness("sample", shape)
    plain = serving_ddim_sampler(srv["qunet"], srv["params"], srv["qstates"], srv["seq"], r.betas, plain=True,
                                 runtime=runtime, **kw)(x2, **draws2)
    rel = _rel(out, plain)
    print(f"[cli] ({label}) whole run ({steps} steps, update {kw['update']}, eta {kw['eta']}) through the kernels vs "
          f"the plain versions on the same generator: mean rel err {rel:.3e} (bound {CHAINED_BOUND}); the "
          f"{batch} PNGs are the sampler's images")
    if not (torch.isfinite(out).all() and rel < CHAINED_BOUND):
        raise AssertionError(f"cli ({label}): kernels vs plain run, mean rel err {rel}")


def cli_phase(cfg, steps, batch, gen):
    """The CLI (`main_torch.main`) at cifar10.yml, --batch_size 128,
    --timesteps quad, serving, --ni, with the exp tree under CLI_EXP:
    (a) --ckpt_path to a reference-named state dict written here from the
    seeded generator (the loaded params held equal to it), --calib_cache
    auto; (b) --sample_type ddpm_noisy; (c) --eta 0.5 --weight_refine off;
    each held by `cli_serving_checks`.  (d) --fid --num_samples 256, ids
    CLI_HOLE and up deleted, run again: every file byte-identical, the PNGs
    read back with zlib equal to the sampler's uint8 images.  (e)
    --execution fake_quant, --fp32, --fp32 --compute_dtype bfloat16."""
    import glob
    import os
    import shutil

    import numpy as np
    import torch

    from attentiondm_tpu_torch.data.transforms import inverse_transform_uint8
    from attentiondm_tpu_torch.models.torch_convert import ddim_state_dict
    from attentiondm_tpu_torch.models.unet import map_tree, unet_init
    from attentiondm_tpu_torch.utils.images import read_png

    shutil.rmtree(CLI_EXP, ignore_errors=True)
    os.makedirs(CLI_EXP)
    params = unet_init(gen, cfg, "cpu")
    ckpt = f"{CLI_EXP}/model-seeded.ckpt"
    torch.save(ddim_state_dict(params, cfg), ckpt)
    print(f"[cli] wrote {ckpt}: the reference's key names, {sum(a.numel() for a in ddim_state_dict(params, cfg).values()) / 1e6:.2f}M "
          f"params from the seeded generator")
    runners = {}
    for label, extra in CLI_SERVING_RUNS.items():
        r, counts = cli_run(label, cli_argv(steps, batch, ckpt, *extra))
        if label == "a":
            got, want = [], []
            map_tree(got.append, r.serving["params"])
            map_tree(want.append, params)
            if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)) or len(got) != len(want):
                raise AssertionError("cli (a): the loaded params differ from the state dict written")
            print(f"[cli] (a) loaded params equal the state dict's, {len(got)} tensors")
        elif "calibration cache" not in r.timings or ("calibration" in r.timings) != (label == "c"):
            raise AssertionError(f"cli ({label}): calibration cache use {sorted(r.timings)}")
        cli_serving_checks(label, r, counts, steps, batch)
        runners[label] = r
        r.serving = None
        torch.cuda.empty_cache()

    argv = cli_argv(steps, batch, ckpt, *SERVING, "--fid", "--calib_cache", "auto", "--image_folder", "fid", n=CLI_FID)
    r, counts = cli_run("d", argv)
    cli_serving_checks("d", r, counts, steps, batch, runs=CLI_FID // batch, full=False)
    folder = r.args.image_folder
    first = {p: open(p, "rb").read() for p in glob.glob(f"{folder}/*.png")}
    if len(first) != CLI_FID:
        raise AssertionError(f"cli (d): {len(first)} files, expected {CLI_FID}")
    for i in range(CLI_HOLE, CLI_FID):
        os.remove(f"{folder}/{i}.png")
    r, counts = cli_run("d, resumed", argv)
    cli_serving_checks("d, resumed", r, counts, steps, batch, runs=(CLI_FID - CLI_HOLE // batch * batch) // batch,
                       full=False)
    again = {p: open(p, "rb").read() for p in glob.glob(f"{folder}/*.png")}
    if again != first or r.fid_images != CLI_FID - CLI_HOLE // batch * batch:
        raise AssertionError(f"cli (d): the resumed files differ ({r.fid_images} images generated again)")
    x, draws = r.randomness("fid", (batch, cfg.resolution, cfg.resolution, cfg.in_channels), 1)
    u8 = inverse_transform_uint8(r.config, r.serving["sampler"](x, **draws)).cpu().numpy()
    if not all((read_png(f"{folder}/{batch + i}.png") == u8[i]).all() for i in range(batch)):
        raise AssertionError("cli (d): the PNGs read back differ from the sampler's uint8 images")
    print(f"[cli] (d) resumed at {CLI_HOLE // batch * batch} after deleting ids {CLI_HOLE}..{CLI_FID - 1}: all "
          f"{CLI_FID} files byte-identical; PNGs {batch}..{2 * batch - 1} read back with zlib equal the sampler's uint8 "
          f"images; PNG encoding {r.timings['png']:.2f} s of background threads, {r.timings['png wait']:.3f} s waited "
          f"after the last batch")
    r.serving = None

    imgs = {}
    for label, extra in CLI_OTHER_RUNS.items():
        r, counts = cli_run(label, cli_argv(steps, batch, ckpt, *extra))
        imgs[label] = np.stack([read_png(f"{r.args.image_folder}/sample_{i}.png") for i in range(batch)]).astype(
            np.float64)
        if any(counts.values()):
            raise AssertionError(f"cli ({label}): no kernel runs off the serving path, counts {counts}")
    a = imgs["fp32"]
    for label in ("fake_quant", "fp32 bf16"):
        print(f"[cli] (e) {label} images vs fp32's: mean abs pixel difference {np.abs(imgs[label] - a).mean():.3f} "
              f"of 255 (information only; random weights)")


TRAIN_EXP = "exp/chip_smoke_train"  # the training path's --exp tree (git-ignored), emptied before the path runs
TRAIN_SET = (10240, 1024)  # the seeded CIFAR-10 stand-in: training images (cut from 50000) and test images
TRAIN_ITERS, TRAIN_SNAPSHOT, TRAIN_MORE = 30, 10, 10  # n_iters, snapshot_freq (cut from 5M, 5000), resumed steps
SYNTH_STEPS, SYNTH_BATCH = 20, 128  # tools/train_synthetic.py's run per distribution
PARITY_IMAGES = 4  # the card-vs-CPU step's batch


def _train_config(n_iters, ema=True):
    """cifar10.yml with the path's cuts (n_iters, snapshot_freq) and `model.ema`, written under TRAIN_EXP; returns
    its path."""
    import yaml

    from attentiondm_tpu_torch.config import CONFIG_DIR

    with open(f"{CONFIG_DIR}/cifar10.yml") as f:
        d = yaml.safe_load(f)
    d["training"].update(n_iters=n_iters, snapshot_freq=TRAIN_SNAPSHOT)
    d["model"]["ema"] = ema
    path = f"{TRAIN_EXP}/cifar10_n{n_iters}{'' if ema else '_params'}.yml"
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def train_argv(config, *extra):
    return ["--config", config, "--doc", "train", "--exp", TRAIN_EXP, "--ni", "--seed", "0", *extra]


def _losses(log_path):
    import csv

    with open(f"{log_path}/train_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    return [int(r["step"]) for r in rows], [float(r["loss"]) for r in rows]


def train_parity(cfg, gen, tx, lr):
    """(a) one training step at full width on PARITY_IMAGES images on the card
    against the same step on the CPU: the same params, batch, t, eps and
    dropout masks.  The loss and the global gradient norm before clipping
    within 1e-5 relative; the params, Adam's moments and the EMA by
    `training.compare_train_states` (the CPU tests' tolerances)."""
    import torch

    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import dropout_shapes, map_tree, unet_apply, unet_init
    from attentiondm_tpu_torch.training import (
        compare_train_states,
        global_norm,
        init_train_state,
        loss_and_grads,
        make_train_step,
    )

    n = PARITY_IMAGES
    params = unet_init(gen, cfg, "cpu")
    x0 = torch.rand((n, cfg.resolution, cfg.resolution, 3), generator=gen) * 2 - 1
    t, e = torch.randint(0, 1000, (n,), generator=gen), torch.randn(x0.shape, generator=gen)
    masks = [torch.rand(s, generator=gen) < 1 - cfg.dropout for s in dropout_shapes(cfg, n)]
    out = {}
    for where in ("cpu", "cuda"):
        betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=where).betas
        state = init_train_state(map_tree(lambda a: a.to(where), params), tx)
        draws = dict(t=t.to(where), e=e.to(where), dropout_masks=[m.to(where) for m in masks])
        _, grads = loss_and_grads(lambda p, x, tt, **r: unet_apply(p, cfg, x, tt, train=True, **r), state.params,
                                  x0.to(where), draws["t"], draws["e"], betas, {"dropout_masks": draws["dropout_masks"]})
        norm = global_norm(grads).item()
        t0 = time.perf_counter()
        new, loss = make_train_step(cfg, betas, tx, grad_clip=1.0, ema_rate=0.9999)(state, x0.to(where), **draws)
        out[where] = (new, loss.item(), norm, time.perf_counter() - t0)
    (gs, gl, gn, gt), (ws, wl, wn, wt) = out["cuda"], out["cpu"]
    res = compare_train_states(gs, ws, lr)
    figs = ", ".join(f"{k} {v[0]:.2e} off, worst {v[1]:.3e}" for k, v in res.items() if k != "ok")
    print(f"[train] (a) one step at full width, {n} images, card vs CPU: loss {gl:.6f} / {wl:.6f} (rel "
          f"{abs(gl - wl) / abs(wl):.2e}), grad norm before clipping {gn:.6f} / {wn:.6f} (rel {abs(gn - wn) / wn:.2e}); "
          f"{figs}; step {gt:.2f} s card, {wt:.2f} s CPU")
    if not (abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-5 * wn and res["ok"]):
        raise AssertionError(f"train (a): the card's step is off the CPU's: {res}")


def step_parts_ms(r, x0, reps=3):
    """Device time (CUDA events, median of `reps`) of a training step's parts
    on the runner's final state and a batch of the dataset: forward +
    backward, the optimizer (clipping, the Adam update and its application)
    and the EMA."""
    import statistics

    import torch

    from attentiondm_tpu_torch.models.ema import ema_update
    from attentiondm_tpu_torch.models.unet import unet_apply
    from attentiondm_tpu_torch.training import (
        antithetic_timesteps,
        apply_updates,
        clip_by_global_norm,
        get_optimizer,
        loss_and_grads,
    )

    cfg, state, tx = r.ucfg, r.train_state, get_optimizer(r.config)
    g = torch.Generator(device="cuda").manual_seed(5)
    parts = collections.defaultdict(list)
    for _ in range(reps):
        t = antithetic_timesteps(g, x0.shape[0], r.num_timesteps)
        e = torch.randn(x0.shape, generator=g, device="cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        _, grads = loss_and_grads(lambda p, x, tt, **k: unet_apply(p, cfg, x, tt, train=True, **k), state.params, x0,
                                  t, e, r.betas, {"generator": g})
        ev[1].record()
        grads, _ = clip_by_global_norm(grads, r.config.optim.grad_clip)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        ev[2].record()
        ema_update(state.ema, params, mu=r.config.model.ema_rate)
        ev[3].record()
        torch.cuda.synchronize()
        for name, a, b in (("forward + backward", 0, 1), ("optimizer", 1, 2), ("EMA", 2, 3)):
            parts[name].append(ev[a].elapsed_time(ev[b]))
        del grads, updates, params
    return {k: statistics.median(v) for k, v in parts.items()}


def step_flops(cfg):
    """A training step's convolution and attention FLOPs per image: 3x the
    forward's (the backward takes the gradients of both operands), the
    forward's counted conv by conv on one image."""
    import torch

    from attentiondm_tpu_torch.models.unet import conv2d, unet_apply, unet_init
    from attentiondm_tpu_torch.ops.checks import attention_sites

    params = unet_init(torch.Generator().manual_seed(0), cfg, "cuda")
    flops = [0]

    def ca(name, x, p, stride=1, padding="SAME"):
        out = conv2d(x, p, stride=stride, padding=padding)
        kh, kw, cin = p["kernel"].shape[:3]
        flops[0] += 2 * out.numel() * kh * kw * cin
        return out

    with torch.no_grad():
        unet_apply(params, cfg, torch.zeros((1, cfg.resolution, cfg.resolution, cfg.in_channels), device="cuda"),
                   torch.zeros(1, device="cuda"), conv_apply=ca)
    attn = sum(2 * 2 * L * L * C for _, L, C in attention_sites(cfg))  # q.k and p.v
    return 3 * (flops[0] + attn)


def train_phase(cfg, steps, gen, profile=False):
    """The training half at cifar10.yml's full width (`train_argv`), batch
    512, on a seeded CIFAR-10 stand-in (TRAIN_SET images made by
    `synthetic_batch` on the card, written as uint8 in CIFAR-10's pickle
    layout under TRAIN_EXP/datasets): (a) `train_parity`; (b) `main_torch`
    trains TRAIN_ITERS steps (every loss finite, the last 10 steps' mean
    below the first 10's, the snapshots, the CSV and the event file; the
    step's wall, device time by part, images/s, peak memory, share of its
    bound; no kernel launched); (c) --resume_training to TRAIN_ITERS +
    TRAIN_MORE (the state loaded equal to ckpt.npz, the first step logged
    the saved one + 1); (d) --test --fp32, then --test --execution serving
    (`steps` quad steps, the launches as `expected_launches`); (e) --sample
    --execution serving --fid on the trained EMA and on the trained params,
    each loaded by name as the config's model.ema says (launches, one step
    site by site and chained, how far from the fp sample); (f)
    tools/train_synthetic.py, SYNTH_STEPS steps of each distribution at
    SYNTH_BATCH, its EMA through --ckpt_path and --resume.  With `profile`,
    one training step on the trained state joins the deferred profiles."""
    import argparse
    import glob
    import os
    import shutil
    import statistics

    import numpy as np
    import torch

    from attentiondm_tpu_torch import checkpoint
    from attentiondm_tpu_torch.config import load_config
    from attentiondm_tpu_torch.data.datasets import get_dataset, write_cifar10
    from attentiondm_tpu_torch.data.synthetic import synthetic_batch
    from attentiondm_tpu_torch.data.transforms import data_transform
    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
    from attentiondm_tpu_torch.models.unet import tree_leaves, unet_apply
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant.int8_serving import serving_unet_apply
    from attentiondm_tpu_torch.runners.diffusion import Diffusion
    from attentiondm_tpu_torch.tools import train_synthetic
    from attentiondm_tpu_torch.training import get_optimizer, make_train_step

    shutil.rmtree(TRAIN_EXP, ignore_errors=True)
    os.makedirs(TRAIN_EXP)
    n_train, n_test = TRAIN_SET
    imgs = synthetic_batch(torch.Generator(device="cuda").manual_seed(0), n_train + n_test, cfg.resolution)
    u8 = ((imgs + 1.0) * 127.5 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    write_cifar10(f"{TRAIN_EXP}/datasets/cifar10", u8, np.random.default_rng(0).integers(0, 10, len(u8)), n_test)
    config = _train_config(TRAIN_ITERS)
    print(f"[train] dataset: {n_train} training and {n_test} test images (synthetic_batch, seed 0) in CIFAR-10's "
          f"pickle layout under {TRAIN_EXP}/datasets; cuts: n_iters {TRAIN_ITERS} (cifar10.yml: 5000000), "
          f"snapshot_freq {TRAIN_SNAPSHOT} (5000), the image count (50000 / 10000)")
    lr = load_config(config).optim.lr
    train_parity(cfg, gen, get_optimizer(load_config(config)), lr)

    # (b) train
    torch.cuda.reset_peak_memory_stats()
    r, counts = cli_run("b: train", train_argv(config), tag="train")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(counts.values()):
        raise AssertionError(f"train (b): the training step launched kernels: {counts}")
    log = r.args.log_path
    steps_logged, losses = _losses(log)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    files = sorted(os.path.basename(p) for p in glob.glob(f"{log}/*.npz"))
    want_files = sorted(["ckpt.npz", "ckpt_1.npz"] + [f"ckpt_{k}.npz" for k in range(TRAIN_SNAPSHOT, TRAIN_ITERS + 1,
                                                                                      TRAIN_SNAPSHOT)])
    events = glob.glob(f"{TRAIN_EXP}/tensorboard/train/events.out.tfevents.*")
    print(f"[train] (b) {len(losses)} steps at batch {r.config.training.batch_size}: loss {losses[0]:.2f} -> "
          f"{losses[-1]:.2f}, mean of the first 10 {first:.2f}, of the last 10 {last:.2f}; files {files}, "
          f"{len(events)} event file")
    if not (steps_logged == list(range(1, TRAIN_ITERS + 1)) and np.isfinite(losses).all() and last < first
            and files == want_files and len(events) == 1):
        raise AssertionError(f"train (b): steps {steps_logged}, losses {losses}, files {files}, events {events}")
    batch = r.config.training.batch_size
    wall = statistics.median(r.step_seconds)
    train_ds = get_dataset(r.args, r.config)[0]
    x0 = data_transform(r.config, torch.from_numpy(np.stack([train_ds[i][0] for i in range(batch)])).cuda())
    parts = step_parts_ms(r, x0)
    flops = step_flops(cfg) * batch
    bound_ms = flops / 67e12 * 1e3
    dev_ms = sum(parts.values())
    print(f"[train] (b) step: wall {wall * 1e3:.1f} ms median of {len(r.step_seconds)} (host clock, loss read one "
          f"step late; snapshots included), {batch / wall:.1f} images/s; device "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
          + f" = {dev_ms:.1f} ms ({batch / dev_ms * 1e3:.1f} images/s); peak memory {peak:.2f} GB "
          f"(max_memory_allocated); bound {bound_ms:.1f} ms ({flops / 1e12:.2f} TFLOP of convs and attention at 67 "
          f"TFLOP/s f32): the device step at {bound_ms / dev_ms:.1%} of it, the wall at {bound_ms / wall / 1e3:.1%}")
    if profile:
        step_fn = make_train_step(cfg, r.betas, get_optimizer(r.config), grad_clip=r.config.optim.grad_clip,
                                  ema_rate=r.config.model.ema_rate)
        DEFERRED_PROFILES.append((f"cifar10-train, one training step at batch {batch}",
                                  lambda fn=step_fn, st=r.train_state, x=x0, g=torch.Generator(device="cuda")
                                  .manual_seed(6): fn(st, x, generator=g), wall * 1e3, True))
    del x0, r
    torch.cuda.empty_cache()

    # (c) resume
    saved = checkpoint.read_flat(f"{log}/ckpt.npz")
    loaded = []
    orig = checkpoint.load_checkpoint

    def spy(*a, **kw):
        loaded.append(orig(*a, **kw))
        return loaded[-1]

    checkpoint.load_checkpoint = spy
    try:
        r, counts = cli_run("c: resume", train_argv(_train_config(TRAIN_ITERS + TRAIN_MORE), "--resume_training"),
                            tag="train")
    finally:
        checkpoint.load_checkpoint = orig
    flat = checkpoint._flatten(loaded[0])
    same = flat.keys() == saved.keys() and all(np.array_equal(flat[k], saved[k]) for k in saved
                                               if not k.endswith("__dc__"))
    steps_logged, losses = _losses(log)
    new = steps_logged[TRAIN_ITERS:]
    print(f"[train] (c) resumed: the state loaded equals ckpt.npz ({len(saved)} keys, step {int(saved['step'])}): "
          f"{same}; steps logged {new[0]}..{new[-1]}; the state ends at step {int(r.train_state.step)}")
    if not (same and new == list(range(TRAIN_ITERS + 1, TRAIN_ITERS + TRAIN_MORE + 1))
            and int(r.train_state.step) == TRAIN_ITERS + TRAIN_MORE and not any(counts.values())):
        raise AssertionError(f"train (c): loaded {same}, steps {new}, counts {counts}")
    del r, loaded, flat
    torch.cuda.empty_cache()

    # (d) --test, float (the EMA, and the params under model.ema false) and served
    serve = ["--timesteps", str(steps), "--skip_type", "quad", "--weight_refine", "off", "--calib_cache", "auto"]
    config = _train_config(TRAIN_ITERS + TRAIN_MORE)
    mse = {}
    for label, cfg_path, extra in (("d: test fp32", config, ["--test", "--fp32"]),
                                   ("d: test fp32, model.ema false", _train_config(TRAIN_ITERS + TRAIN_MORE, ema=False),
                                    ["--test", "--fp32"]),
                                   ("d: test served", config, ["--test", *SERVING, *serve])):
        r, counts = cli_run(label, train_argv(cfg_path, *extra), tag="train")
        mse[label] = r.test_result["eps_mse"]
        res = r.test_result
        print(f"[train] ({label}) eps-MSE {res['eps_mse']:.4f} ({res['desc']}) over {res['seen']}/{res['total']} "
              f"test images, {res['batches']} batches of {res['batch']}"
              + (f", {res['steps_covered']}/{res['steps']} sampler steps" if "steps" in res else "")
              + f"; {r.timings['test']:.2f} s")
        expected = (checks.expected_launches(r.ucfg, res["batches"], res["batch"], attn_int8=False,
                                             residual_dtype=torch.float32)
                    if "--execution" in extra else {k: 0 for k in counts})
        if counts != expected or not np.isfinite(res["eps_mse"]):
            raise AssertionError(f"train ({label}): launches {counts}, expected {expected}; {res}")
    # the EMA at rate 0.9999 has moved 1 - 0.9999^40 = 0.4% of the way from the init: the trained params test lower
    if not mse["d: test fp32, model.ema false"] < mse["d: test fp32"]:
        raise AssertionError(f"train (d): the trained params test no lower than the EMA: {mse}")

    # (e) the trained weights served: the EMA (cifar10.yml's model.ema; (d)'s calibration cache) and the params
    # (model.ema false; a cache of their own: the cache's header names the flags, not the weights)
    for label, cfg_path, cache in (("e: serve the EMA", config, "auto"),
                                   ("e: serve the params", _train_config(TRAIN_ITERS + TRAIN_MORE, ema=False),
                                    f"{TRAIN_EXP}/calib_params.npz")):
        extra = ["--sample", *SERVING, *serve[:-1], cache, "--fid", "--num_samples", "128", "--batch_size", "128",
                 "--image_folder", label.split()[-1]]
        r, counts = cli_run(label, train_argv(cfg_path, *extra), tag="train")
        cli_serving_checks(label, r, counts, steps, 128, full=False)
        want = checkpoint.load_checkpoint(f"{log}/ckpt.npz", r.serving["params"],
                                          prefix="ema" if "EMA" in label else "params", device="cuda")
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(r.serving["params"]), tree_leaves(want))):
            raise AssertionError(f"train ({label}): the served params are not ckpt.npz's")
        if ("calibration" in r.timings) != (cache != "auto"):
            raise AssertionError(f"train ({label}): calibration cache use {sorted(r.timings)}")
        srv = r.serving
        shape = (128, cfg.resolution, cfg.resolution, cfg.in_channels)
        x, draws = r.randomness("fid", shape, 0)
        t0 = torch.full((128,), float(srv["seq"][-1]), device="cuda")
        kw = srv["kwargs"]
        flags = {k: kw[k] for k in ("attn_int8", "attn_ranges", "residual_dtype")}
        held_step(lambda plain: serving_unet_apply(srv["params"], r.ucfg, srv["qunet"], srv["sampler"].runtime,
                                                   srv["qstates"], x, t0, 0, plain=plain, **flags), "train")
        with torch.no_grad():
            served = srv["sampler"](x, **draws)
            fp = ddim_sample(lambda xt, t, i: unet_apply(srv["params"], r.ucfg, xt, t), x, srv["seq"], r.betas)
        print(f"[train] ({label}) ckpt.npz's `{'ema' if 'EMA' in label else 'params'}` served: {r.fid_images} PNGs, "
              f"finite {bool(torch.isfinite(served).all())}; the served sample from the fp sample of the same weights "
              f"and noise: mean rel {_rel(served, fp):.4e}, mean abs {(served - fp).abs().mean().item():.4e}")
        if not torch.isfinite(served).all() or r.fid_images != 128:
            raise AssertionError(f"train ({label}): {r.fid_images} images, finite {torch.isfinite(served).all()}")
        del r, srv, served, fp
        torch.cuda.empty_cache()

    # (f) tools/train_synthetic.py
    for dist in ("procedural", "natural"):
        out = f"{TRAIN_EXP}/synthetic_{dist}.npz"
        checks.reset_launches()
        t0 = time.perf_counter()
        state, losses = train_synthetic.train(steps=SYNTH_STEPS, batch=SYNTH_BATCH, seed=0, log_every=5, out=out,
                                              dist=dist)
        secs = time.perf_counter() - t0
        counts = checks.read_launches()
        rr = Diffusion(argparse.Namespace(ckpt_path=out, seed=0), load_config(config))
        loaded = rr._load_params()
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded), tree_leaves(state.ema)))
        again, _ = train_synthetic.train(steps=2, batch=SYNTH_BATCH, seed=0, log_every=1, resume=out, dist=dist)
        print(f"[train] (f) train_synthetic {dist}: {SYNTH_STEPS} steps at batch {SYNTH_BATCH} in {secs:.1f} s (saves "
              f"included), losses {[round(v, 2) for v in losses]}; the EMA loads through --ckpt_path equal: {same}; "
              f"--resume continues to step {int(again.step)}")
        if not (np.isfinite(losses).all() and same and int(again.step) == SYNTH_STEPS + 2 and not any(counts.values())):
            raise AssertionError(f"train (f) {dist}: losses {losses}, loaded {same}, step {int(again.step)}, "
                                 f"counts {counts}")
        del state, again, loaded
    shutil.rmtree(TRAIN_EXP, ignore_errors=True)


QUALITY_EXP = "exp/chip_smoke_quality"  # the quality path's tree (git-ignored), emptied before the path runs
QUALITY_TRAIN = (60, 128)  # train_synthetic's steps (cut from 12000) and batch
QUALITY_LADDER = dict(batch=64, calib_batch=8, bit_configs=((8, 8), (4, 8)), stage2=True, serving=True, kid=True,
                      adaround=True, weight_rows="gptq")
INCEPTION_CHECK, INCEPTION_IMAGES, INCEPTION_BATCH = 8, 1024, 256  # card vs CPU images; timed images and batch
INCEPTION_REL = 1e-4  # card vs CPU features: max |difference| / max |feature| (the CPU tests' bound against JAX)
QUALITY_REF, QUALITY_FID, QUALITY_FID_BATCH = 512, 256, 128  # stand-in reference PNGs; --fid images and batch
FID_REL = 1e-6  # the runner's FID against the API it scores with (`sharded_statistics`) on the same folder
FID64_REL = 1e-4  # ... and against the float64 route (features on the host, `np.cov`)


def _stand_in_images(n, seed, res=32):
    """n float [0, 1] NHWC images of `synthetic_batch` (procedural shapes) on the card."""
    import torch

    from attentiondm_tpu_torch.data.synthetic import synthetic_batch

    return (synthetic_batch(torch.Generator(device="cuda").manual_seed(seed), n, res) + 1.0) * 0.5


def quality_eval():
    """(eval) The seeded random Inception on the card against the same
    network on the CPU (INCEPTION_CHECK images at 32^2, < INCEPTION_REL);
    INCEPTION_IMAGES images' features at INCEPTION_BATCH timed by CUDA events
    (images/s, peak memory, the share of the convolutions' f32 bound); and
    `sharded_statistics` (float32 sums of f and f f^T on the card, JAX's
    form) against float64 mean and `np.cov` over the same features."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from attentiondm_tpu_torch.eval.fid import sharded_statistics
    from attentiondm_tpu_torch.eval.inception import InceptionV3FID

    net, net_cpu = InceptionV3FID.random(device="cuda"), InceptionV3FID.random(device="cpu")
    x = _stand_in_images(INCEPTION_CHECK, 3)
    got, want = net.extract(x).cpu(), net_cpu.extract(x.cpu())
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[quality] (eval) random Inception, {INCEPTION_CHECK} images at 32^2, card vs CPU: max rel err {rel:.3e} "
          f"(bound {INCEPTION_REL:g}); features {tuple(got.shape)}")
    if not (torch.isfinite(got).all() and rel < INCEPTION_REL):
        raise AssertionError(f"quality (eval): the card's Inception is off the CPU's: {rel}")
    with FlopCounterMode(display=False) as fc:
        net_cpu.extract(x[:1].cpu())
    flops = fc.get_total_flops()

    imgs = _stand_in_images(INCEPTION_IMAGES, 4)
    net.extract(imgs[:INCEPTION_BATCH])  # warm: cuDNN's algorithm choice
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    feats = torch.cat([net.extract(imgs[i:i + INCEPTION_BATCH]) for i in range(0, INCEPTION_IMAGES, INCEPTION_BATCH)])
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    bound_ms = flops * INCEPTION_IMAGES / F32_FLOPS_PER_S * 1e3
    print(f"[quality] (eval) features of {INCEPTION_IMAGES} images at batch {INCEPTION_BATCH}: {ms:.1f} ms device "
          f"(CUDA events), {INCEPTION_IMAGES / ms * 1e3:.1f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {flops / 1e9:.2f} GFLOP an image (the convolutions "
          f"at 299^2, FlopCounterMode), bound {bound_ms:.1f} ms at 67 TFLOP/s f32: {bound_ms / ms:.1%}")
    f64 = feats.double().cpu().numpy()
    mu64, sig64 = f64.mean(axis=0), np.cov(f64, rowvar=False)
    mu, sig = sharded_statistics(feats, lambda f: f, batch_size=INCEPTION_BATCH)
    mu_rel = float(np.abs(mu - mu64).max() / np.abs(mu64).max())
    sig_rel = float(np.abs(sig - sig64).max() / np.abs(sig64).max())
    print(f"[quality] (eval) sharded_statistics (float32 sums on the card) vs float64 mean / np.cov over the same "
          f"{INCEPTION_IMAGES} features: mu max rel err {mu_rel:.3e}, sigma max rel err {sig_rel:.3e} (max |sigma| "
          f"{np.abs(sig64).max():.3e}, mean |mu| {np.abs(mu64).mean():.3e}, mean feature std "
          f"{np.sqrt(np.diag(sig64)).mean():.3e})")
    if not (np.isfinite(sig).all() and np.isfinite(mu).all()):
        raise AssertionError("quality (eval): sharded_statistics is not finite")


def quality_ladder(cfg, steps):
    """(ladder) `tools/train_synthetic` trains `cfg` QUALITY_TRAIN steps,
    then `tools/quality_protocol.run_protocol` runs on its EMA at `steps`
    quad steps with QUALITY_LADDER's rows.  Each row's launches are read as
    it lands: a serving row (its sampler and its eps scan, 2 x `steps`
    steps) launches what `expected_launches` says, any other row nothing.
    Every row finite, fp32 0, w8a8_s1 at or below w4a8_s1.  Returns the EMA's
    path."""
    import numpy as np
    import torch

    from attentiondm_tpu_torch.checkpoint import save_checkpoint
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.tools import train_synthetic
    from attentiondm_tpu_torch.tools.quality_protocol import format_table, run_protocol

    n_steps, batch = QUALITY_TRAIN
    t0 = time.perf_counter()
    state, losses = train_synthetic.train(steps=n_steps, batch=batch, seed=0, log_every=n_steps // 4, cfg=cfg)
    ckpt = f"{QUALITY_EXP}/ema.npz"
    save_checkpoint(ckpt, state.ema)
    print(f"[quality] (ladder) train_synthetic: {n_steps} steps at batch {batch} in {time.perf_counter() - t0:.1f} s, "
          f"losses {[round(v, 2) for v in losses]}; the EMA at {ckpt}")
    counts = {}

    def on_row(name, row):
        counts[name] = checks.read_launches()
        checks.reset_launches()

    ema = state.ema
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    checks.reset_launches()
    t0 = time.perf_counter()
    rows = run_protocol(ema, cfg, steps=steps, on_row=on_row, **QUALITY_LADDER)
    secs = time.perf_counter() - t0
    flags = ", ".join(f"{k} {v}" for k, v in QUALITY_LADDER.items())
    print(f"[quality] (ladder) run_protocol, DDIM-{steps} quad, {flags}: {secs:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for line in format_table(rows).splitlines():
        print(f"[quality] {line}")
    bad = []
    for name, row in rows.items():
        if not all(np.isfinite(v) for k, v in row.items() if not (name == "fp32" and k == "psnr")):
            bad.append(f"{name} not finite: {row}")
        res = torch.bfloat16 if "bf16res" in name else torch.float32
        want = (checks.expected_launches(cfg, 2 * steps, QUALITY_LADDER["batch"], attn_int8=False, residual_dtype=res)
                if name.startswith("int8_") else {k: 0 for k in counts[name]})
        if counts[name] != want:
            bad.append(f"{name}: launches {counts[name]}, expected {want}")
    served = [n for n in rows if n.startswith("int8_")]
    print(f"[quality] (ladder) {len(served)} serving rows ({', '.join(served)}), each launching "
          f"{checks.expected_launches(cfg, 2 * steps, QUALITY_LADDER['batch'], attn_int8=False)} as expected: "
          f"{not any('launches' in b for b in bad)}")
    fp = rows["fp32"]
    if fp["eps_rel_mse_mean"] != 0 or fp["eps_rel_mse_max"] != 0 or fp.get("kid", 0) != 0:
        bad.append(f"fp32 row {fp}")
    if not rows["w8a8_s1"]["eps_rel_mse_mean"] <= rows["w4a8_s1"]["eps_rel_mse_mean"]:
        bad.append(f"w8a8_s1 {rows['w8a8_s1']} above w4a8_s1 {rows['w4a8_s1']}")
    if bad:
        raise AssertionError("quality (ladder): " + "; ".join(bad))
    return ckpt


def quality_fid(ckpt, steps):
    """(fid) `eval.fid --save-stats` over QUALITY_REF stand-in PNGs written by
    `utils/images`; then `main_torch.main(--sample --fid --fid_stats
    --execution serving)` on the trained EMA, QUALITY_FID images at
    QUALITY_FID_BATCH, no --inception_weights (the seeded random Inception):
    its launches, and its FID (as printed and as returned) finite, equal to
    the API's that JAX's runner scores with (`sharded_statistics` +
    `frechet_smoke_safe`) over the same folder within FID_REL, and within
    FID64_REL of the float64 route (`compute_statistics_of_path`)."""
    import contextlib
    import io
    import re

    import numpy as np

    from attentiondm_tpu_torch.eval import fid
    from attentiondm_tpu_torch.eval.inception import InceptionV3FID
    from attentiondm_tpu_torch.utils.images import write_png_batch

    ref_dir, stats = f"{QUALITY_EXP}/reference", f"{QUALITY_EXP}/reference_stats.npz"
    write_png_batch(_stand_in_images(QUALITY_REF, 5).cpu().numpy(), ref_dir, 0)
    t0 = time.perf_counter()
    if fid.main([ref_dir, stats, "--save-stats", "--batch-size", str(INCEPTION_BATCH)]) != 0:
        raise AssertionError("quality (fid): eval.fid --save-stats failed")
    print(f"[quality] (fid) eval.fid --save-stats over {QUALITY_REF} stand-in PNGs: {time.perf_counter() - t0:.1f} s")
    argv = ["--config", "cifar10.yml", "--doc", "quality", "--exp", QUALITY_EXP, "--sample", "--ni", "--batch_size",
            str(QUALITY_FID_BATCH), "--num_samples", str(QUALITY_FID), "--timesteps", str(steps), "--skip_type",
            "quad", "--ckpt_path", ckpt, *SERVING, "--weight_refine", "off", "--fid", "--fid_stats", stats,
            "--image_folder", "fid"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r, counts = cli_run("fid", argv, tag="quality")
    print(out.getvalue(), end="")
    printed = [float(v) for v in re.findall(r"^FID: (\S+)$", out.getvalue(), re.M)]
    cli_serving_checks("fid", r, counts, steps, QUALITY_FID_BATCH, runs=QUALITY_FID // QUALITY_FID_BATCH, full=False)
    net = InceptionV3FID.random(device="cuda")
    folder = r.args.image_folder
    mu, sigma = fid.sharded_statistics(fid._iter_image_dir(folder, INCEPTION_BATCH), net.extract)
    mu64, sigma64 = fid.compute_statistics_of_path(folder, net.extract, batch_size=INCEPTION_BATCH)
    with np.load(stats) as f:
        api = fid.frechet_smoke_safe(mu, sigma, f["mu"], f["sigma"], QUALITY_FID)
        api64 = fid.frechet_smoke_safe(mu64, sigma64, f["mu"], f["sigma"], QUALITY_FID)
    rel, rel64 = abs(r.fid_score - api) / abs(api), abs(r.fid_score - api64) / abs(api64)
    print(f"[quality] (fid) {r.fid_images} images scored after the --fid loop: printed {printed}, returned "
          f"{r.fid_score:.8f}, the API's {api:.8f} (rel {rel:.2e}, bound {FID_REL:g}), the float64 route's "
          f"{api64:.8f} (rel {rel64:.2e}, bound {FID64_REL:g}); scoring {r.timings['fid score']:.2f} s")
    if not (len(printed) == 1 and np.isfinite(r.fid_score) and rel < FID_REL and rel64 < FID64_REL
            and abs(printed[0] - r.fid_score) <= 5e-5 + 1e-6 * abs(r.fid_score)):
        raise AssertionError(f"quality (fid): printed {printed}, returned {r.fid_score}, API {api}, "
                             f"float64 {api64}")


def quality_onramp():
    """(on-ramp and bench) `tools/real_ckpt` on stand-in assets in a temp
    dir (a `TorchDDIMUNet` toy's state dict under the registry's name, a
    randomized `TorchFIDInception`, reference statistics): the golden check
    (< 5e-4), a finite sample, the statistics saved; then
    `tools/train_bench --batches 512 --steps 5`."""
    import json as _json
    import os
    import tempfile

    import numpy as np
    import torch

    from attentiondm_tpu_torch.tools import real_ckpt, train_bench

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    try:
        from torch_inception_oracle import TorchFIDInception, randomize_
        from torch_oracle import TorchDDIMUNet
    finally:
        sys.path.pop(0)
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/toy.yml", "w") as f:
            f.write("data:\n    dataset: CIFAR10\n    image_size: 16\n    channels: 3\n"
                    "model:\n    in_channels: 3\n    out_ch: 3\n    ch: 32\n    ch_mult: [1, 2]\n"
                    "    num_res_blocks: 1\n    attn_resolutions: [8]\n    dropout: 0.0\n    resamp_with_conv: True\n")
        torch.manual_seed(0)
        torch.save(TorchDDIMUNet(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16)
                   .state_dict(), f"{tmp}/model-790000.ckpt")
        torch.save(randomize_(TorchFIDInception(), seed=3).state_dict(), f"{tmp}/pt_inception-2015-12-05-6726825d.pth")
        a = np.random.default_rng(0).standard_normal((8, 2048))
        np.savez(f"{tmp}/fid_stats_cifar10_train.npz", mu=a.mean(0), sigma=np.cov(a, rowvar=False))
        t0 = time.perf_counter()
        rep = real_ckpt.main(["--name", "cifar10", "--dir", tmp, "--config", f"{tmp}/toy.yml", "--steps", "4",
                              "--sample_batch", "4", "--fid", "8", "--out", f"{tmp}/report.json", "--grid",
                              f"{tmp}/grid.png"])
        saved = os.path.exists(f"{tmp}/report_stats.npz")
        print(f"[quality] (on-ramp) real_ckpt on stand-in assets: {time.perf_counter() - t0:.1f} s, golden "
              f"{rep.get('golden_max_abs_diff')}, sampling finite {rep.get('sampling_finite')}, features "
              f"{rep.get('inception_feat_dim')}, stats saved {saved}, FID {rep.get('fid')}")
        if not (rep.get("golden_max_abs_diff") is not None and rep["golden_max_abs_diff"] < real_ckpt.GOLDEN_TOL
                and rep.get("sampling_finite") and saved and np.isfinite(rep.get("fid", np.nan))):
            raise AssertionError(f"quality (on-ramp): {rep}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        summary = train_bench.main(["--batches", "512", "--steps", "5", "--json", f"{tmp}/bench.json"])
        with open(f"{tmp}/bench.json") as f:
            same = _json.load(f) == _json.loads(_json.dumps(summary))
    (r,) = summary["results"]
    print(f"[quality] (bench) train_bench at batch 512, 5 steps: {r['step_ms']:.1f} ms a step wall, "
          f"{r['device_ms']:.1f} device, {r['img_per_s']:.1f} images/s, peak {r['max_memory_gb']:.2f} GB, loss "
          f"{r['loss']:.2f}; checkpoint {summary['checkpoint']}; JSON written: {same}; {time.perf_counter() - t0:.1f} s")
    if not (same and np.isfinite(r["loss"]) and r["img_per_s"] > 0):
        raise AssertionError(f"quality (bench): {summary}")


def quality_phase(cfg, steps):
    """The cifar10-quality path: `quality_eval`, `quality_ladder`,
    `quality_fid` on the ladder's trained EMA, `quality_onramp`."""
    import os
    import shutil

    shutil.rmtree(QUALITY_EXP, ignore_errors=True)
    os.makedirs(QUALITY_EXP)
    phase("cifar10-quality", "eval", quality_eval)
    ckpt = phase("cifar10-quality", "ladder", quality_ladder, cfg, steps)
    phase("cifar10-quality", "fid", quality_fid, ckpt, steps)
    phase("cifar10-quality", "on-ramp and bench", quality_onramp)
    shutil.rmtree(QUALITY_EXP, ignore_errors=True)


def phase(path, name, fn, *args, **kwargs):
    """fn(*args, **kwargs), and its host-clock seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[phase] {path} {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler's device time per kernel for one sampler run")
    ap.add_argument("--paths", default=",".join(BATCH),
                    help=f"the paths to run, comma-separated (default: all of {', '.join(BATCH)})")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if not paths or any(p not in BATCH for p in paths):
        raise SystemExit(f"chip_smoke: --paths takes names among {', '.join(BATCH)}, got {args.paths!r}")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the GPU")
    from attentiondm_tpu_torch.ops import _build

    card = nvidia_smi_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    so, seconds = _build.build()
    _build.kernels()
    print(f"[build] {so.name}: {seconds:.1f} s (nvcc, sm_90a)")

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    kernels = []
    for path in paths:
        t0 = time.perf_counter()
        cfg, sched, label = path_config(path)
        steps = min(args.steps, MAX_STEPS.get(path, args.steps))
        print(f"== {path}: {label}, batch {BATCH[path]}")
        report = Report()
        if path == "cifar10-cli":
            ctx = phase(path, "cli", cli_phase, cfg, steps, BATCH[path], gen)
            launches_of = {}
        elif path == "cifar10-train":
            ctx = phase(path, "train", train_phase, cfg, steps, gen, args.profile)
            launches_of = {}
        elif path == "cifar10-quality":
            ctx = quality_phase(cfg, steps)
            launches_of = {}
        elif path == "cifar10-enhanced":
            phase(path, "kernels", kernel_phase, cfg, BATCH[path], gen, dev, report)
            counts, ctx = phase(path, "slice", enhanced_slice_phase, cfg, sched, label, steps, BATCH[path], gen, dev,
                                args.profile)
            lever_counts = phase(path, "levers", levers_phase, ctx, timed=False)
            launches_of = {**counts["mp core"], **{key: lever_counts[key] for key in ("K4", "K7", "K12")}}
        elif path == "cifar10-f32":
            phase(path, "kernels", f32_kernel_phase, cfg, BATCH[path], gen, dev, report)
            counts, ctx = phase(path, "slice", slice_phase, cfg, sched, label, steps, BATCH[path], gen, dev,
                                args.profile, {F32_STREAM: dict(residual_dtype=torch.float32, **F32_CORE)})
            f32_counts = phase(path, "f32", f32_phase, ctx)
            icounts = phase(path, "interception", interception_phase, ctx)
            lev = f32_counts["three levers"]
            launches_of = {"K3.f32": counts[F32_STREAM]["K3"], "K12.f32": lev["K12"], "K4.f32": lev["K4"],
                           "K7.f32": lev["K7"], "K1.resadd_f32": lev["K3"] + lev["K12"],
                           "K2.int32": f32_counts["dot_bf16=False"]["K2"], "K13": icounts["K13"],
                           "K5": icounts["K5"]}
        elif path == "celeba-wide":
            phase(path, "attention kernels", attention_kernel_phase, cfg, BATCH[path], gen, dev, report)
            phase(path, "epilogue kernels", epilogue_phase, cfg, BATCH[path], gen, dev, report)
            counts, ctx = phase(path, "slice", slice_phase, cfg, sched, label, steps, BATCH[path], gen, dev,
                                args.profile, ATTN_SETTINGS)
            launches_of = {**{key: counts[run][key] for key, run in ATTN_RUN.items()},
                           "K2": counts["static int8"]["K2"]}
        else:
            phase(path, "kernels", kernel_phase, cfg, BATCH[path], gen, dev, report, both_cores=path == "imagenet64")
            counts, ctx = phase(path, "slice", slice_phase, cfg, sched, label, steps, BATCH[path], gen, dev,
                                args.profile)
            lever_counts = phase(path, "levers", levers_phase, ctx, timed=path == "cifar10", profile=args.profile)
            if path == "imagenet64":
                phase(path, "folds", fold_forms_phase, ctx)
            if path == "cifar10":
                phase(path, "weights", weights_phase, ctx)
                phase(path, "stage2", stage2_phase, ctx)
            launches_of = {**counts["f32 core"], **{key: lever_counts[key] for key in ("K4", "K7", "K12")},
                           "K3.core": counts["f32 core"]["K3"]}
        del ctx
        for key, (name, source, replaces) in META.items():
            if key not in report.rows:
                continue
            r = report.rows[key]
            launches = launches_of[key]
            kernels.append({"name": f"{key} {name}", "path": path, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
                            "ms": round(r["ms"], 4), "device_ms": round(r["device_ms"], 4),
                            "plain_ms": round(r["plain_ms"], 4),
                            "bound_ms": round(r["bound_ms"], 4),
                            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
                            "library_ms": None if r["library_ms"] is None else round(r["library_ms"], 4)})
            if launches == 0:
                raise AssertionError(f"{key} was not launched on the {path} path")
        torch.cuda.empty_cache()
        print(f"== {path}: {time.perf_counter() - t0:.1f} s")
    for label, run, wall_ms, *split in DEFERRED_PROFILES:
        profile_sampler(label, run, wall_ms, split=bool(split))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
