#!/bin/sh
# Attention-precision ablation (4 variants A-D) on the PyTorch / CUDA port:
# run_attention_ablation.sh's flags on attentiondm_tpu_torch.tools.ablation_attention.
# Pass --ckpt / --inception-weights for real-model runs, --device cpu off the card.
python -u -m attentiondm_tpu_torch.tools.ablation_attention \
    --config cifar10.yml \
    --out ablation_out \
    --steps 50 \
    --num-samples 64 \
    --sampler ddpm \
    "$@"
