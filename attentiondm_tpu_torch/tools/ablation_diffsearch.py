"""Differentiable architecture-importance search, a (lambda, eta) sweep
(port of `attentiondm_tpu/tools/ablation_diffsearch.py`).

Sigmoid gates over {resblock, attention, temb} scale the UNet's residual
branches, attention changes and timestep embedding (`unet_apply(gates=)`);
for each (lambda, eta) pair, Adam at rate eta (the port's optax-shaped
`training.adamw`) minimizes eps-MSE + lambda * L1(gates) over the gate
logits alone, the UNet's params fixed, and the gates' trajectories are
recorded (`diff_search_results.json`, `weights_evolution.png`).  The loss
and its gradient run under `exact_f32()` (no TF32 on the card, backward
included).

    python3 -m attentiondm_tpu_torch.tools.ablation_diffsearch [--config ablation_config.yml] \\
        [--out diff_search_out] [--steps 20] [--device cpu]

It runs on the current CUDA device unless `device=` names another.  Draws
come from torch.Generators seeded at JAX's offsets from `seed`: the params
from `seed` (where none are given), x0 from seed + 1, and each step's t and
eps from one generator seeded seed + 2 at the start of every pair, so that
every pair sees the same draws, as JAX's `fold_in(PRNGKey(seed + 2), i)`
gives them.  `x0=`, `t=` [steps, batch] and `e=` [steps, batch, H, W, C]
hand in other draws.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, Sequence

import torch

from .. import default_device
from ..diffusion.losses import noise_estimation_loss
from ..diffusion.schedules import DiffusionSchedule
from ..models.unet import UNetConfig, unet_apply, unet_init
from ..ops.precision import exact_f32
from ..training import adamw, apply_updates

GATES = ("resblock", "attention", "temb")


def run_diff_search(config, out_dir: str, *, params=None, lambdas: Sequence[float] = (0.01, 0.1),
                    etas: Sequence[float] = (0.01, 0.05), steps: int = 20, batch: int = 4, seed: int = 0,
                    device=None, x0=None, t=None, e=None, plot: bool = True) -> Dict[str, dict]:
    """{"lambda=<l>_eta=<e>": {"final_weights", "loss", "weights_evolution"}}
    for every pair, also written to `<out_dir>/diff_search_results.json`;
    with `plot`, the trajectories to `<out_dir>/weights_evolution.png`
    (matplotlib)."""
    device = default_device() if device is None else torch.device(device)
    cfg = UNetConfig.from_config(config)
    betas = DiffusionSchedule.from_config(config, device=device).betas
    num_timesteps = betas.shape[0]
    if params is None:
        params = unet_init(torch.Generator().manual_seed(seed), cfg, device)
    os.makedirs(out_dir, exist_ok=True)
    shape = (batch, cfg.resolution, cfg.resolution, cfg.in_channels)
    if x0 is None:
        x0 = torch.randn(shape, generator=torch.Generator(device=device).manual_seed(seed + 1), device=device)

    def draws(i, g):
        if t is not None:
            return t[i].to(device), e[i].to(device)
        return (torch.randint(0, num_timesteps, (batch,), generator=g, device=device),
                torch.randn(shape, generator=g, device=device))

    def loss_fn(logits, ti, ei, lam):
        gates = {k: torch.sigmoid(v) for k, v in logits.items()}
        mse, _ = noise_estimation_loss(lambda x, tt: unet_apply(params, cfg, x, tt, gates=gates), x0, ti, ei, betas)
        sparsity = sum(g.abs().sum() for g in gates.values())
        return mse + lam * sparsity

    results = {}
    for lam in lambdas:
        for eta in etas:
            logits = {k: torch.zeros((), device=device) for k in GATES}
            tx = adamw(eta)
            opt_state = tx.init(logits)
            g = torch.Generator(device=device).manual_seed(seed + 2)
            hist = {k: [] for k in logits}
            losses = []
            for i in range(steps):
                ti, ei = draws(i, g)
                leaves = {k: v.detach().requires_grad_(True) for k, v in logits.items()}
                with exact_f32():  # the backward's convs too: no TF32 on the card
                    loss = loss_fn(leaves, ti, ei, lam)
                    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
                updates, opt_state = tx.update(grads, opt_state, logits)
                logits = apply_updates(logits, updates)
                losses.append(float(loss.detach()))
                for k in logits:
                    hist[k].append(float(torch.sigmoid(logits[k])))
            key_name = f"lambda={lam}_eta={eta}"
            results[key_name] = {"final_weights": {k: hist[k][-1] for k in hist}, "loss": losses,
                                 "weights_evolution": hist}
            logging.info(f"{key_name}: final gates {results[key_name]['final_weights']}")

    if plot:
        _plot_evolution(results, os.path.join(out_dir, "weights_evolution.png"))
    with open(os.path.join(out_dir, "diff_search_results.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def _plot_evolution(results, out_path):
    """One panel a (lambda, eta) pair: each gate against the step."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(results)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for ax, (name, r) in zip(axes[0], results.items()):
        for comp, ys in r["weights_evolution"].items():
            ax.plot(ys, label=comp)
        ax.set_title(name, fontsize=8)
        ax.set_xlabel("step")
        ax.set_ylabel("gate")
        ax.legend(fontsize=6)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv=None):
    import argparse

    from ..config import load_config

    ap = argparse.ArgumentParser(description="differentiable architecture-importance search")
    ap.add_argument("--config", default="ablation_config.yml")
    ap.add_argument("--out", default="diff_search_out")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_diff_search(load_config(args.config), args.out, steps=args.steps, device=args.device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
