"""Training throughput (port of `attentiondm_tpu/tools/train_bench.py`):
steps/s and images/s of the training step at the config's optimizer,
clipping and EMA (cifar10.yml: Adam 2e-4, clip 1.0, EMA 0.9999), at several
batch sizes, and the checkpoint save / resume round trip.

    python3 -m attentiondm_tpu_torch.tools.train_bench [--config cifar10.yml] [--batches 128,256,512] \\
        [--steps 20] [--json out.json]

The step is `training.make_train_step` on one device under `exact_f32()`
(the runner's `train()` step), or under torchrun (`torchrun
--nproc_per_node N -m attentiondm_tpu_torch.tools.train_bench`) the data-
parallel `make_sharded_train_step` over a mesh of the N ranks, as JAX's
bench runs over its device mesh (the batch is the global one; rank 0
prints), on one fixed batch of uniform [-1, 1] images
with the step's t, eps and dropout drawn from a seeded generator; host
batch assembly is left out (the runner overlaps it).  After `warmup` steps,
each of which waits for the loss, `steps` steps are queued back to back and
timed by the host clock from the first launch to the last loss, and by CUDA
events on the device (`device_ms` a step); `max_memory_gb` is
`torch.cuda.max_memory_allocated` over the batch's run.  It runs on the
current CUDA device (`--device cpu` for the CPU, where the device figures
are null).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import checkpoint as ckpt_io
from .. import default_device
from ..config import load_config
from ..diffusion.schedules import DiffusionSchedule
from ..models.unet import UNetConfig, tree_leaves, unet_init
from ..ops.precision import exact_f32
from ..parallel import initialize_distributed, make_mesh
from ..training import get_optimizer, init_train_state, make_sharded_train_step


def bench_batch(ucfg, betas, config, batch: int, steps: int, warmup: int = 3, device=None, mesh=None):
    """(results, the final training state) of `steps` timed steps at
    `batch` (the global batch over a `mesh` of several ranks)."""
    device = default_device() if device is None else torch.device(device)
    cuda = device.type == "cuda"
    tx = get_optimizer(config)
    params = unet_init(torch.Generator().manual_seed(0), ucfg, device)
    state = init_train_state(params, tx, use_ema=bool(config.model.ema))
    kw = dict(grad_clip=getattr(config.optim, "grad_clip", None),
              ema_rate=config.model.ema_rate if config.model.ema else None)
    step_fn = make_sharded_train_step(make_mesh() if mesh is None else mesh, ucfg, betas, tx, **kw)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-1, 1, (batch, ucfg.resolution, ucfg.resolution, 3)), dtype=torch.float32,
                         device=device)
    g = torch.Generator(device=device).manual_seed(1)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with exact_f32():
        t_c0 = time.perf_counter()
        for _ in range(warmup):
            state, loss = step_fn(state, x0, generator=g)
            loss.item()  # waits: first-use setup, then the steady state
        t_warm = time.perf_counter() - t_c0

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        for _ in range(steps):
            state, loss = step_fn(state, x0, generator=g)
        if cuda:
            ev[1].record()
        loss_h = loss.item()  # the last loss waits for every queued step
        dt = time.perf_counter() - t0
    return {
        "batch": batch,
        "steps": steps,
        "step_ms": 1e3 * dt / steps,
        "steps_per_s": steps / dt,
        "img_per_s": batch * steps / dt,
        "device_ms": ev[0].elapsed_time(ev[1]) / steps if cuda else None,
        "max_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
        "loss": loss_h,
        "warmup_s": t_warm,
    }, state


def bench_checkpoint(state, path: str, device=None):
    """Save the training state, load it back onto the device and read every
    param (the L1 sum proves the round trip touched the data)."""
    t0 = time.perf_counter()
    ckpt_io.save_checkpoint(path, state)
    t_save = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    restored = ckpt_io.load_checkpoint(path, state, device=device)
    check = float(sum(a.abs().float().sum() for a in tree_leaves(restored.params)))
    t_load = time.perf_counter() - t0
    return {"save_s": t_save, "load_s": t_load, "size_mb": size_mb, "param_l1": check}


def _rounded(d, nd=4):
    return {k: round(v, nd) if isinstance(v, float) else v for k, v in d.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description="training throughput at the config's optimizer, clipping and EMA")
    ap.add_argument("--config", default="cifar10.yml", help="config YAML (a bare name is a packaged config)")
    ap.add_argument("--batches", default="128,256,512")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    initialize_distributed(device=args.device)  # torchrun's ranks join; alone, a no-op
    device = default_device() if args.device is None else torch.device(args.device)
    config = load_config(args.config)
    ucfg = UNetConfig.from_config(config)
    betas = DiffusionSchedule.from_config(config, device=device).betas
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    mesh = make_mesh()
    main_rank = mesh.coords.get("data", 0) == 0
    print(f"device: {device} ({name})" + (f"  mesh: {mesh.shape}" if mesh.size > 1 else ""))

    results, state = [], None
    for b in (int(x) for x in args.batches.split(",")):
        state = None  # the last batch's state goes before the next one's is made
        if device.type == "cuda":
            torch.cuda.empty_cache()
        r, state = bench_batch(ucfg, betas, config, b, args.steps, device=device, mesh=mesh)
        if main_rank:
            print(json.dumps(_rounded(r)))
        results.append(r)

    with tempfile.TemporaryDirectory() as tmp:
        ck = bench_checkpoint(state, os.path.join(tmp, "train_bench_ckpt.npz"), device)
    print(json.dumps(_rounded(ck, 3)))

    best = max(results, key=lambda r: r["img_per_s"])
    summary = {"metric": "train_img_per_s", "value": round(best["img_per_s"], 2), "unit": "img/s",
               "device": name, "devices": mesh.size, "batch": best["batch"], "step_ms": round(best["step_ms"], 2),
               "checkpoint": {k: round(v, 3) for k, v in ck.items() if k != "param_l1"},
               "results": [_rounded(r) for r in results]}
    if not main_rank:
        return summary
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
