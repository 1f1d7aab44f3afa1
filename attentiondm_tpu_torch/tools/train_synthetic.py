"""Train a UNet on a distribution made on the device (port of
`attentiondm_tpu/tools/train_synthetic.py`), for weights with learned
activation statistics where no dataset or published checkpoint is at hand.

The runner's training step (`training.make_train_step`: eps-MSE at
antithetic timesteps, clipping at 1.0, Adam, the EMA), on batches that
`data.synthetic.synthetic_batch` (procedural shapes) or `natural_batch`
(natural-image statistics) make on the device each step.  The images and
the step's draws come from one torch.Generator seeded with `seed + 1`.

    python3 -m attentiondm_tpu_torch.tools.train_synthetic --steps 12000 --batch 128 \\
        --out exp/synthetic_ckpt.npz [--dist natural] [--config celeba.yml] [--resume exp/synthetic_ckpt.npz]

`--out` receives the EMA param tree, which `main_torch.py --ckpt_path`
loads, and `<out>.train.npz` the whole training state, which `--resume`
continues from.  It runs on the current CUDA device (`train(device="cpu")`
for the CPU).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import default_device
from ..checkpoint import load_checkpoint, save_checkpoint
from ..data.synthetic import natural_batch, synthetic_batch
from ..diffusion.schedules import DiffusionSchedule
from ..models.unet import UNetConfig, unet_init
from ..training import adamw, init_train_state, make_train_step


def train(steps: int = 12000, batch: int = 128, lr: float = 2e-4, ema_rate: float = 0.999, seed: int = 0,
          cfg: UNetConfig | None = None, log_every: int = 200, out: str | None = None, resume: str | None = None,
          dist: str = "procedural", device=None):
    """Train for `steps` steps; returns (the training state, the losses read every `log_every` steps)."""
    device = default_device() if device is None else torch.device(device)
    cfg = cfg or UNetConfig()  # CIFAR-10's UNet, 35.75M params
    sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=device)
    tx = adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    state = init_train_state(unet_init(torch.Generator().manual_seed(seed), cfg, device), tx)
    if resume:
        state = load_checkpoint(resume if resume.endswith(".train.npz") else resume + ".train.npz", state,
                                device=device)
    step_fn = make_train_step(cfg, sched.betas, tx, grad_clip=1.0, ema_rate=ema_rate)
    data_fn = {"procedural": synthetic_batch, "natural": natural_batch}[dist]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    t0 = time.time()
    losses = []
    for i in range(steps):
        x0 = data_fn(g, batch, cfg.resolution)
        state, loss = step_fn(state, x0, generator=g)
        if (i + 1) % log_every == 0:
            lv = loss.item()  # waits for the device: the rate below is the device's
            losses.append(lv)
            print(f"step {i + 1}/{steps}  loss {lv:.4f}  {(i + 1) * batch / (time.time() - t0):.0f} img/s", flush=True)
    if out:
        save_checkpoint(out, state.ema)  # the EMA param tree, for --ckpt_path
        save_checkpoint(out + ".train.npz", state)  # the whole training state, for --resume
        print(f"saved EMA checkpoint to {out} (+ .train.npz for resume)")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema_rate", type=float, default=0.999)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--dist", type=str, default="procedural", choices=["procedural", "natural"],
                    help="training distribution: procedural shapes, or natural statistics (1/f^alpha spectrum, "
                         "opponent-color covariance, lognormal contrast)")
    ap.add_argument("--config", type=str, default=None,
                    help="config YAML whose model group replaces CIFAR-10's UNetConfig (e.g. celeba.yml)")
    args = ap.parse_args(argv)
    cfg = None
    if args.config:
        from ..config import load_config

        cfg = UNetConfig.from_config(load_config(args.config))
    train(cfg=cfg, steps=args.steps, batch=args.batch, lr=args.lr, ema_rate=args.ema_rate, seed=args.seed,
          out=args.out, resume=args.resume, dist=args.dist)


if __name__ == "__main__":
    main()
