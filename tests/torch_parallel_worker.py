"""One rank of the port's parallel tests (tests/test_torch_parallel*.py).

Not a pytest file (no `test_` prefix): the tests spawn it with
`torch.multiprocessing` (`spawn_ranks`), and each child imports this module,
so it imports torch and the port only, never JAX.  A rank joins the others
over gloo through a FileStore (`initialize_distributed("file://...",
device="cpu")`), runs one task on the payload the test pickled (numpy
arrays, config namespaces) and pickles its result to `<out>/rank<r>.pkl`.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from attentiondm_tpu_torch.parallel.distributed import rank_device

JOIN_TIMEOUT = 240  # seconds a test waits for its ranks


def spawn_ranks(tmp_path, world: int, task: str, payload: dict, timeout: float = JOIN_TIMEOUT) -> list:
    """Run `task` on `world` spawned ranks; their results in rank order.  A
    rank that fails or outlives `timeout` fails the caller (the others are
    killed)."""
    import torch.multiprocessing as mp

    tmp_path = str(tmp_path)
    out = os.path.join(tmp_path, f"ranks_{task}_{time.monotonic_ns()}")
    os.makedirs(out)
    with open(os.path.join(out, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    store = os.path.join(out, "store")
    ctx = mp.start_processes(entry, args=(world, store, task, out), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{task}: the ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def entry(rank: int, world: int, store: str, task: str, out: str):
    torch.set_num_threads(1)
    from attentiondm_tpu_torch.parallel import initialize_distributed

    with open(os.path.join(out, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    if payload.get("device") == "cuda":  # the ranks share the one card over gloo, as asked for by naming it
        os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    assert initialize_distributed(f"file://{store}", world, rank, 120,
                                  device="cuda:0" if payload.get("device") == "cuda" else "cpu") is (world > 1)
    result = TASKS[task](payload)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _tree_np(tree):
    from attentiondm_tpu_torch.models.unet import map_tree

    return map_tree(lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else a, tree)


def _params(payload):
    from attentiondm_tpu_torch.models.unet import from_jax_params

    return from_jax_params(payload["params"], device=rank_device())


def _mesh(payload):
    from attentiondm_tpu_torch.parallel import make_mesh

    shape = payload["mesh"]
    return make_mesh(axes=("data", "model")[:len(shape)], shape=shape)


def forward(payload):
    """The sharded forward (tp or sp) of `params` at x, t; with `cot`, the
    gradients of sum(eps * cot) over the params, whole, and over x."""
    from attentiondm_tpu_torch.models.unet import UNetConfig, tree_leaves, tree_unflatten, unet_apply
    from attentiondm_tpu_torch.parallel import (UNetParallel, gather_unet_params, shard_batch,
                                                shard_batch_spatial, shard_unet_params, unet_param_specs)
    from attentiondm_tpu_torch.parallel.collectives import all_reduce

    cfg = UNetConfig(**payload["cfg"])
    mesh, mode = _mesh(payload), payload["mode"]
    params = _params(payload)
    specs = unet_param_specs(params)
    dev = rank_device()
    x, t = torch.tensor(payload["x"], device=dev), torch.tensor(payload["t"], device=dev)
    if mode == "tp":
        local = shard_unet_params(mesh, params)
        xl, tl = shard_batch(mesh, x), shard_batch(mesh, t)
    else:
        local = params
        xl, tl = shard_batch_spatial(mesh, x), shard_batch(mesh, t)
    par = UNetParallel.of(mesh, mode)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
    xl = xl.clone().requires_grad_(True)
    eps = unet_apply(tree_unflatten(local, leaves), cfg, xl, tl, parallel=par)
    res = {"eps": eps.detach().cpu().numpy(), "coords": dict(mesh.coords),
           "conv1_local": tuple(local["down"][0]["block"][0]["conv1"]["kernel"].shape)}
    if payload.get("cot") is not None:
        cot = torch.tensor(payload["cot"], device=dev)
        cot = shard_batch(mesh, cot) if mode == "tp" else shard_batch_spatial(mesh, cot)
        grads = torch.autograd.grad((eps * cot).sum(), leaves + [xl], materialize_grads=True)
        gx, grads = grads[-1], list(grads[:-1])
        groups = [mesh.groups["data"]] + ([mesh.groups["model"]] if mode == "sp" else [])
        for g in groups:
            if g is not None:
                grads = [all_reduce(a, g) for a in grads]
        whole = gather_unet_params(mesh, tree_unflatten(local, grads), specs) if mode == "tp" else \
            tree_unflatten(local, grads)
        res["grads"] = _tree_np(whole)
        res["gx"] = gx.cpu().numpy()
    return res


def train(payload):
    """`steps` sharded train steps from the given params on the given
    per-step draws; each step's loss and the final state, gathered whole."""
    from attentiondm_tpu_torch.models.unet import UNetConfig
    from attentiondm_tpu_torch.parallel import gather_unet_params, shard_unet_params, unet_param_specs
    from attentiondm_tpu_torch.training import adamw, init_train_state, make_sharded_train_step

    cfg = UNetConfig(**payload["cfg"])
    mesh, mode = _mesh(payload), payload["mode"]
    params = _params(payload)
    specs = unet_param_specs(params) if mode == "tp" else None
    if mode == "tp":
        params = shard_unet_params(mesh, params)
    tx = adamw(payload["lr"])
    state = init_train_state(params, tx)
    betas = torch.tensor(payload["betas"])
    step = make_sharded_train_step(mesh, cfg, betas, tx, param_specs=specs, spatial=mode == "sp",
                                   grad_clip=payload.get("grad_clip", 1.0), ema_rate=payload.get("ema_rate", 0.9999))
    x0 = torch.tensor(payload["x0"])
    losses = []
    for d in payload["draws"]:
        if d.get("seed") is not None:
            kw = {"generator": torch.Generator().manual_seed(d["seed"])}
        else:
            kw = {"t": torch.tensor(d["t"]), "e": torch.tensor(d["e"])}
        state, loss = step(state, x0, **kw)
        losses.append(float(loss))
    res = {"losses": losses, "conv1_local": tuple(state.params["down"][0]["block"][0]["conv1"]["kernel"].shape),
           "mu_local": tuple(state.opt_state[0].mu["down"][0]["block"][0]["conv1"]["kernel"].shape)}
    if mode == "tp":
        whole = lambda tree: gather_unet_params(mesh, tree, specs)  # noqa: E731
    else:
        whole = lambda tree: tree  # noqa: E731
    res.update(params=_tree_np(whole(state.params)), ema=_tree_np(whole(state.ema)),
               mu=_tree_np(whole(state.opt_state[0].mu)), nu=_tree_np(whole(state.opt_state[0].nu)))
    return res


def runner(payload):
    """`Diffusion(args, config, device=<the rank's>)` runs, one after the
    other, on every rank: `payload["runs"]` is a list of (args, config,
    method); per run the runner's log messages, its launch counts (set to 0
    just before it) and the step it trained to."""
    import logging

    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.runners.diffusion import Diffusion

    outs = []
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for args, config, method in payload["runs"]:
        records = []

        class Keep(logging.Handler):
            def emit(self, rec):
                records.append(rec.getMessage())

        h = Keep(level=logging.INFO)
        root.addHandler(h)
        try:
            r = Diffusion(args, config, device=rank_device())
            checks.reset_launches()
            getattr(r, method)()
            counts = checks.read_launches()
        finally:
            root.removeHandler(h)
        out = {"log": records, "counts": counts}
        if method == "train":
            out["step"] = int(r.train_state.step)
            out["conv1_local"] = tuple(r.train_state.params["down"][0]["block"][0]["conv1"]["kernel"].shape)
        outs.append(out)
    return outs


def stats(payload):
    """`sharded_statistics` of the images over a data mesh, with a fixed
    linear feature map (features = mean colour @ proj, tanh); `replicate`
    of each rank's own value and `shard_batch` of a range."""
    import torch.distributed  # noqa: F401

    from attentiondm_tpu_torch.eval.fid import sharded_statistics
    from attentiondm_tpu_torch.parallel import replicate, shard_batch

    proj = torch.tensor(payload["proj"])
    mesh = _mesh(payload)

    def extract(x):
        return torch.tanh(x.reshape(x.shape[0], -1, x.shape[-1]).mean(dim=1) @ proj)

    mu, sigma = sharded_statistics(payload["images"], extract, mesh=mesh, batch_size=payload["batch_size"],
                                   device="cpu")
    mine = {"v": [torch.full((2,), float(torch.distributed.get_rank()))]}
    return {"mu": mu, "sigma": sigma, "replicated": replicate(mesh, mine)["v"][0].tolist(),
            "shard": shard_batch(mesh, torch.arange(6)).tolist()}


def smoke(payload):
    """The multi-process smoke (tests/mp_smoke_worker.py's twin): one data-
    parallel train step and one sharded W4A8 serving batch; the loss and the
    checksum are products of cross-rank collectives."""
    import torch.distributed as dist

    from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, make_timestep_seq
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import UNetConfig, unet_apply, unet_init
    from attentiondm_tpu_torch.parallel import make_mesh, shard_batch
    from attentiondm_tpu_torch.parallel.collectives import all_gather, all_reduce
    from attentiondm_tpu_torch.quant.calibrate import calibrate_ranges
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler
    from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
    from attentiondm_tpu_torch.training import adamw, init_train_state, make_sharded_train_step

    n = dist.get_world_size()
    mesh = make_mesh(n)
    sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 100, device="cpu")
    cfg = UNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)
    tx = adamw(2e-4)
    state = init_train_state(unet_init(torch.Generator().manual_seed(0), cfg, "cpu"), tx)
    x0 = torch.randn((n * 2, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    step = make_sharded_train_step(mesh, cfg, sched.betas, tx)
    state, loss = step(state, x0, generator=torch.Generator().manual_seed(2))
    assert np.isfinite(float(loss))

    cfg_q = UNetConfig(ch=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
    params_q = unet_init(torch.Generator().manual_seed(3), cfg_q, "cpu")
    steps = 3
    seq = make_timestep_seq(100, steps, "uniform")
    x_cal = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        _, traj, _ = ddim_sample(lambda xt, t, i: unet_apply(params_q, cfg_q, xt, t), x_cal, seq, sched.betas,
                                 keep_trajectory=True)
    xs_in = torch.cat([x_cal[None], traj[:-1]])
    qunet = QuantizedUNet.create(cfg_q, bitwidth=4, a_bitwidth=8)
    qstates = calibrate_ranges(qunet, params_q, qunet.init_state(steps, "cpu"), xs_in, seq)
    sample = serving_ddim_sampler(qunet, params_q, qstates, seq, sched.betas, attn_int8=False)
    x = torch.randn((n * 2, 8, 8, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        out = sample(shard_batch(mesh, x))
    whole = torch.cat(all_gather(out, mesh.groups["data"]))
    checksum = float(all_reduce(out.abs().sum(), mesh.groups["data"]))
    return {"loss": float(loss), "checksum": checksum, "local": tuple(out.shape), "whole": whole.numpy()}


TASKS = {"forward": forward, "train": train, "runner": runner, "stats": stats, "smoke": smoke}
