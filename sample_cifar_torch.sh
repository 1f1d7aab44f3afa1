#!/bin/sh
# Canonical quantized CIFAR-10 sampling on the PyTorch / CUDA port: sample_cifar.sh's
# flags on main_torch.py (DDIM-100, quad skip, 6-bit quantization, entropy-driven
# active timestep selection, attention-focused calibration, bulk FID generation).
python -u main_torch.py \
    --config cifar10.yml \
    --exp experiments/cifar10_sampling \
    --doc cifar10_w6 \
    --sample --fid --timesteps 100 --eta 0 --ni \
    --image_folder results/cifar10_samples \
    --skip_type quad \
    --bitwidth 6 \
    --calib_t_mode diff \
    --calibrate_attention \
    "$@"
