#!/usr/bin/env python3
"""CLI of the PyTorch / CUDA port: the flags, defaults and folder handling of
`main.py`, dispatched to `attentiondm_tpu_torch.runners.Diffusion`.

    python3 main_torch.py --config cifar10.yml --doc cifar10 --sample --execution serving --ni \
        --batch_size 128 --timesteps 100 --skip_type quad [--fid --num_samples 50000] [--ckpt_path PATH]

    python3 main_torch.py --config cifar10.yml --doc cifar10 --ni [--resume_training]
    python3 main_torch.py --config cifar10.yml --doc cifar10 --test [--execution serving] [--num_samples N]

Dispatch: --sample -> runner.sample(); --test -> runner.test() (the test
split's eps-MSE); else runner.train() (the training state under
exp/logs/<doc>, `ckpt.npz`, which --sample and --test then load by name).
The runner runs on the current CUDA device and stops when there is none.
Under torchrun (`torchrun --nproc_per_node N main_torch.py ...`) the ranks
join first (`parallel.initialize_distributed`): sampling and --fid split
each batch over them, and training runs data parallel, or data x tensor
(`--tp`) or data x spatial (`--sp`) parallel.
"""
import argparse
import logging
import os
import shutil
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from attentiondm_tpu_torch.config import load_config, namespace2dict  # noqa: E402

_HANDLERS = []  # the log handlers this module installed, replaced on the next call


def parse_args_and_config(argv=None):
    parser = argparse.ArgumentParser(description=globals()["__doc__"])
    parser.add_argument("--config", type=str, required=True, help="Path to the config file")
    parser.add_argument("--seed", type=int, default=1234, help="Random seed")
    parser.add_argument("--exp", type=str, default="exp", help="Path for saving running related data.")
    parser.add_argument("--doc", type=str, required=True, help="Name of the log folder.")
    parser.add_argument("--comment", type=str, default="", help="Experiment comment")
    parser.add_argument("--verbose", type=str, default="info", help="info | debug | warning | critical")
    parser.add_argument("--test", action="store_true", help="Whether to test the model")
    parser.add_argument("--sample", action="store_true", help="Produce samples from the model")
    parser.add_argument("--fid", action="store_true", help="Bulk generation for FID (50k default)")
    parser.add_argument("--fid_stats", type=str, default=None,
                        help="reference stats (.npz) or image dir: score the --fid run "
                             "in-process after generation (generate->score in one command)")
    parser.add_argument("--inception_weights", type=str, default=None,
                        help="pt_inception torch checkpoint for --fid_stats scoring "
                             "(omit: seeded random-init net, relative comparisons only)")
    parser.add_argument("--interpolation", action="store_true")
    parser.add_argument("--resume_training", action="store_true")
    parser.add_argument("-i", "--image_folder", type=str, default="images", help="Folder name for samples")
    parser.add_argument("--ni", action="store_true", help="No interaction (Slurm-friendly)")
    parser.add_argument("--use_pretrained", action="store_true")
    parser.add_argument("--sample_type", type=str, default="generalized", help="generalized | ddpm_noisy")
    parser.add_argument("--skip_type", type=str, default="uniform", help="uniform | uniform_ref | quad")
    parser.add_argument("--timesteps", type=int, default=1000, help="number of sampler steps")
    parser.add_argument("--eta", type=float, default=0.0, help="DDIM eta")
    parser.add_argument("--calibrate_attention", action="store_true",
                        help="Run stage-2 attention-focused calibration")
    parser.add_argument("--attention_loss_weight", type=float, default=0.5,
                        help="entropy weight for the attention-focused stage-2 calibration")
    parser.add_argument("--calib_epochs", type=int, default=1,
                        help="stage-2 trajectory passes (1 = reference-faithful single pass)")
    parser.add_argument("--calib_t_mode", default="real", type=str,
                        choices=["real", "range", "diff", "random"])
    parser.add_argument("--sequence", action="store_true")
    parser.add_argument("--dist_url", default="env://", help="distributed init url (taken for main.py's flag set; one GPU)")
    parser.add_argument("--bitwidth", type=int, default=8, help="weight/activation bitwidth")
    parser.add_argument("--a_bitwidth", type=int, default=None, help="activation bitwidth override (e.g. W4A8)")
    parser.add_argument("--fp32", action="store_true", help="disable quantization")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="activation dtype for the sampling forward pass")
    parser.add_argument("--normgroup", type=int, default=0,
                        help="override quantization group count for every layer (0 = per-layer defaults)")
    parser.add_argument("--attn_variant", type=str, default="ddim", choices=["ddim", "enhanced"],
                        help="attention block flavor (enhanced = per-projection quantized MHA)")
    parser.add_argument("--mixed_precision_attention", action="store_true",
                        help="stage-3 calibration + quantized attention core (enhanced variant only)")
    parser.add_argument("--diff_loss_weight", type=float, default=1.0)
    parser.add_argument("--sample_weight", type=float, default=2.0,
                        help="'diff' t-mode sample-count penalty")
    parser.add_argument("--num_samples", type=int, default=None,
                        help="images to generate (default 64; 50000 with --fid)")
    parser.add_argument("--batch_size", type=int, default=None, help="override sampling batch size")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="checkpoint to load (.npz native or torch .ckpt/.pth)")
    parser.add_argument("--execution", type=str, default="fake_quant",
                        choices=["fake_quant", "serving"],
                        help="quantized execution engine: fake_quant intercepts convs "
                             "(reference-faithful); serving runs the fused int8-resident "
                             "path (quant/int8_serving.py — the fast one)")
    parser.add_argument("--attn_int8", action="store_true",
                        help="serving only: run attention cores as fused int8 kernels "
                             "(default: the f32 cores)")
    parser.add_argument("--step_chunk", type=int, default=None,
                        help="serving only: fold per-step int8 weights k steps at a "
                             "time to bound HBM (big models / long schedules)")
    parser.add_argument("--superbatch", type=int, default=None,
                        help="serving+step_chunk only: generate this many images per "
                             "sampler pass, advanced micro-batch-wise through each "
                             "weight-fold chunk (amortizes fold work on 50k runs)")
    parser.add_argument("--shared_fold", action="store_true",
                        help="serving only: constrain activation scales to the "
                             "step-factorized rank-1 form (quant/rank1.py) so the "
                             "folded int8 weights are STEP-SHARED — fold HBM drops "
                             "from S x params to params, making --step_chunk "
                             "unnecessary at any schedule length (fold-once speed "
                             "for every model/schedule; quality via the protocol)")
    parser.add_argument("--pack_int4", action="store_true",
                        help="serving only: store w_bit<=4 folded weights as two "
                             "nibbles per byte — half the fold HBM, bit-exact")
    parser.add_argument("--tp", type=int, default=1,
                        help="training: tensor-parallel degree (Megatron-paired UNet "
                             "shardings over a (data, model) mesh; must divide the "
                             "device count and the 32 GroupNorm groups)")
    parser.add_argument("--sp", type=int, default=1,
                        help="training: spatial-parallel degree — shard the image "
                             "height over the mesh (halo-exchanged convs; the "
                             "activation-memory axis for 256x256 models). "
                             "Exclusive with --tp.")
    parser.add_argument("--weight_opt", type=str, default="gptq",
                        choices=["off", "biascorr", "adaround", "gptq"],
                        help="serving weight-quality pass: GPTQ error-compensated "
                             "rounding + bias correction (default; measured 28.4 dB "
                             "vs AdaRound's 19.6 at W4A8), AdaRound rounding "
                             "optimization + bias correction, bias correction only, "
                             "or plain round-to-nearest. GPTQ Grams are collected "
                             "in chunked passes up to K=kh*kw*cin<=12288 (covers "
                             "every layer of every shipped config); larger layers "
                             "fall back to bias-corrected rounding with a logged "
                             "advisory")
    parser.add_argument("--weight_refine", type=str, default="perstep",
                        choices=["off", "shared", "perstep"],
                        help="trajectory-distilled fold refinement after the weight "
                             "pass: per-output-channel out_mult/bias_delta corrections "
                             "optimized against the FP32 teacher's eps (shared across "
                             "steps, or an independent per-step set — runtime-free "
                             "either way, the fold bakes per-step constants). Default "
                             "perstep: measured W4A8 18.4 -> 30.0 dB at zero serving "
                             "cost; best-iterate selection makes it never-worse")
    parser.add_argument("--adaround_iters", type=int, default=1000,
                        help="AdaRound optimizer iterations per layer")
    parser.add_argument("--stage2_mode", type=str, default="reference",
                        choices=["reference", "teacher"],
                        help="stage-2 objective: the reference's fresh-noise MSE + "
                             "entropy, or teacher-matched eps distillation on the "
                             "FP32 trajectory (measured to actually help)")
    parser.add_argument("--stage2_lr", type=float, default=0.02,
                        help="teacher-matched stage-2 learning rate")
    parser.add_argument("--calib_cache", type=str, default=None,
                        help="path (or 'auto' = <log_path>/calib_cache.npz) to "
                             "persist/reuse calibration state across runs")

    args = parser.parse_args(argv)
    args.log_path = os.path.join(args.exp, "logs", args.doc)

    config = load_config(args.config)
    if args.batch_size:
        config.sampling.batch_size = args.batch_size

    level = getattr(logging, args.verbose.upper(), None)
    if not isinstance(level, int):
        raise ValueError(f"level {args.verbose} not supported")

    handlers = [logging.StreamHandler()]
    first = int(os.environ.get("RANK", 0)) == 0  # torchrun's rank 0 clears and writes the folders; the others read
    if not args.test and not args.sample and first:
        if not args.resume_training:
            if os.path.exists(args.log_path):
                if args.ni or input("Folder already exists. Overwrite? (Y/N)").upper() == "Y":
                    shutil.rmtree(args.log_path)
                else:
                    print("Folder exists. Program halted.")
                    sys.exit(0)
            os.makedirs(args.log_path, exist_ok=True)
            import yaml

            with open(os.path.join(args.log_path, "config.yml"), "w") as f:
                yaml.dump(namespace2dict(config), f, default_flow_style=False)
        else:
            os.makedirs(args.log_path, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(args.log_path, "stdout.txt")))
    elif args.sample:
        os.makedirs(os.path.join(args.exp, "image_samples"), exist_ok=True)
        args.image_folder = os.path.join(args.exp, "image_samples", args.image_folder)
        if os.path.exists(args.image_folder) and not (args.fid or args.interpolation) and first:
            if args.ni or input(
                f"Image folder {args.image_folder} already exists. Overwrite? (Y/N)"
            ).upper() == "Y":
                shutil.rmtree(args.image_folder)
            else:
                print("Output image folder exists. Program halted.")
                sys.exit(0)
        os.makedirs(args.image_folder, exist_ok=True)

    fmt = logging.Formatter("%(levelname)s - %(filename)s - %(asctime)s - %(message)s")
    logger = logging.getLogger()
    for h in _HANDLERS:
        logger.removeHandler(h)
        h.close()
    _HANDLERS[:] = handlers
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.setLevel(level)

    np.random.seed(args.seed)
    return args, config


def main(argv=None) -> int:
    """Run the CLI on `argv` (None: the process's); 0 on success, 1 after an
    error (logged with its traceback).  The runner of the call stays on
    `main.runner`."""
    args, config = parse_args_and_config(argv)
    logging.info(f"Writing log file to {args.log_path}")
    logging.info(f"Exp instance id = {os.getpid()}")
    logging.info(f"Exp comment = {args.comment}")

    from attentiondm_tpu_torch.parallel import initialize_distributed
    from attentiondm_tpu_torch.runners.diffusion import Diffusion

    main.runner = None
    try:
        initialize_distributed()  # torchrun's environment joins the ranks; without it a no-op
        main.runner = runner = Diffusion(args, config)
        if args.sample:
            runner.sample()
        elif args.test:
            runner.test()
        else:
            runner.train()
    except Exception:
        logging.error(traceback.format_exc())
        return 1
    return 0


main.runner = None

if __name__ == "__main__":
    sys.exit(main())
