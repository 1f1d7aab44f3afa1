"""Serving-throughput sweep: a (batch, step_chunk) grid for any config
(port of `attentiondm_tpu/tools/serving_sweep.py`).

Seeded random weights, an FP DDIM teacher on one image, stage-1
calibration, then one `serving_ddim_sampler` (the CUDA kernels) per
variant: `step_chunk` none (the whole fold once, one fold shared by every
batch), an int (the fold made `step_chunk` steps at a time inside each
run), "shared" (the rank-1 step-shared fold, `rank1=True`) or "packed"
(the fold once with int4-packed weights, `pack_int4=True`).  Each variant
runs once untimed (its fold and first use), then the timed reps go in
turns across the variants; each timing ends on a device sync (the output's
sum read back) inside the timed region.  A variant that runs out of device
memory prints an error row and drops out; any other failure raises.

    python3 -m attentiondm_tpu_torch.tools.serving_sweep --config church.yml \\
        --timesteps 20 --batches 8,16,32 --step_chunks none,5,10 [--device cpu]

Prints one JSON line per variant plus the winner.  It runs on the current
CUDA device unless `device=` names another.  Draws come from
torch.Generators at JAX's offsets from `seed`: the params from `seed`, the
teacher's image from seed + 1, each variant's first run from seed + 2 (the
same input for every variant of one batch), rep r from seed + 5 + r.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def sweep(config_name: str, timesteps: int, batches, step_chunks, w_bit: int = 4, a_bit: int = 8,
          skip_type: str = "quad", reps: int = 3, attn_int8: bool = False, seed: int = 0, ucfg_override=None,
          device=None, record: dict | None = None):
    """The rows {"batch", "step_chunk", "img_per_sec" (the best rep),
    "all"} of the variants that ran.  `record`, where given, is filled with
    {(batch, step_chunk): {"out": the first run's output, "launches": the
    kernel launches of that run (`ops.checks.read_launches` before and
    after)}}."""
    from .. import default_device
    from ..config import load_config
    from ..diffusion.sampling import ddim_sample, make_timestep_seq
    from ..diffusion.schedules import DiffusionSchedule
    from ..models.unet import UNetConfig, count_params, unet_apply, unet_init
    from ..ops.checks import read_launches
    from ..quant.calibrate import calibrate_ranges
    from ..quant.int8_serving import prepare_serving_runtime, serving_ddim_sampler
    from ..quant.qunet import QuantizedUNet

    device = default_device() if device is None else torch.device(device)
    c = load_config(config_name)
    cfg = ucfg_override or UNetConfig.from_config(c)
    params = unet_init(torch.Generator().manual_seed(seed), cfg, device)
    n_par = count_params(params)
    betas = DiffusionSchedule.create(c.diffusion.beta_schedule, c.diffusion.beta_start, c.diffusion.beta_end,
                                     c.diffusion.num_diffusion_timesteps, device=device).betas
    seq = make_timestep_seq(c.diffusion.num_diffusion_timesteps, timesteps, skip_type)
    R = cfg.resolution
    print(json.dumps({"config": config_name, "params_M": round(n_par / 1e6, 1), "res": R, "steps": timesteps,
                      "fold_gb_unchunked": round(timesteps * n_par / 1e9, 2)}), flush=True)

    def normal(shape, s):
        return torch.randn(shape, generator=torch.Generator(device=device).manual_seed(s), device=device)

    x_small = normal((1, R, R, 3), seed + 1)
    with torch.no_grad():
        _, traj, _ = ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x_small, seq, betas,
                                 keep_trajectory=True)
    xs_in = torch.cat([x_small[None], traj[:-1]], dim=0)
    qunet = QuantizedUNet.create(cfg, bitwidth=w_bit, a_bitwidth=a_bit)
    qstates = calibrate_ranges(qunet, params, qunet.init_state(timesteps, device), xs_in, seq, first=True)

    # one fold shared by every unchunked variant: it depends on the quant
    # state only, not on the batch
    shared_rt = prepare_serving_runtime(qunet, params, qstates) if None in step_chunks else None

    def error_row(B, ck, e):
        print(json.dumps({"batch": B, "step_chunk": ck, "error": str(e)[:160]}), flush=True)

    samplers = {}
    for B in batches:
        for ck in step_chunks:
            try:
                s = serving_ddim_sampler(qunet, params, qstates, seq, betas, residual_dtype=torch.bfloat16,
                                         attn_int8=attn_int8, step_chunk=ck if isinstance(ck, int) else None,
                                         rank1=(ck == "shared"), pack_int4=(ck == "packed"),
                                         runtime=shared_rt if ck is None else None)
                before = read_launches()
                out = s(normal((B, R, R, 3), seed + 2))
                v = float(out.sum())  # the fold and first use; the read-back waits for the device
                if not np.isfinite(v):
                    raise FloatingPointError(f"serving_sweep: batch {B}, step_chunk {ck}: non-finite output")
                if record is not None:
                    after = read_launches()
                    record[(B, ck)] = {"out": out, "launches": {k: after[k] - before[k] for k in after}}
                del out
                samplers[(B, ck)] = s
            except torch.OutOfMemoryError as e:
                error_row(B, ck, e)

    res = {k: [] for k in samplers}
    for rep in range(reps):
        for (B, ck), s in list(samplers.items()):
            x = normal((B, R, R, 3), seed + 5 + rep)
            try:
                t0 = time.perf_counter()
                v = float(s(x).sum())
                res[(B, ck)].append(B / (time.perf_counter() - t0))
            except torch.OutOfMemoryError as e:  # a run-time OOM (fragmentation after a neighbour): drop it
                del samplers[(B, ck)], res[(B, ck)]
                error_row(B, ck, e)
                continue
            if not np.isfinite(v):
                raise FloatingPointError(f"serving_sweep: batch {B}, step_chunk {ck}: non-finite output")

    rows = []
    for (B, ck), vals in res.items():
        row = {"batch": B, "step_chunk": ck, "img_per_sec": round(max(vals), 3), "all": [round(v, 3) for v in vals]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if rows:
        print(json.dumps({"winner": max(rows, key=lambda r: r["img_per_sec"])}), flush=True)
    return rows


def parse_chunks(spec: str):
    """'none' / '0' -> None, 'shared' / 'packed' as they are, else an int."""
    out = []
    for c in spec.split(","):
        c = c.strip().lower()
        out.append(None if c in ("none", "0") else (c if c in ("shared", "packed") else int(c)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True, help="e.g. church.yml")
    p.add_argument("--timesteps", type=int, default=20)
    p.add_argument("--batches", default="8,16,32", help="comma-separated batch sizes")
    p.add_argument("--step_chunks", default="none",
                   help="comma-separated chunk sizes; 'none' = fold-once; 'shared' = rank-1 step-shared fold "
                        "(params-sized); 'packed' = fold-once int4-packed (half the fold's bytes)")
    p.add_argument("--bitwidth", type=int, default=4)
    p.add_argument("--a_bitwidth", type=int, default=8)
    p.add_argument("--skip_type", default="quad")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--attn_int8", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    a = p.parse_args(argv)
    return sweep(a.config, a.timesteps, [int(b) for b in a.batches.split(",")], parse_chunks(a.step_chunks),
                 w_bit=a.bitwidth, a_bit=a.a_bitwidth, skip_type=a.skip_type, reps=a.reps, attn_int8=a.attn_int8,
                 device=a.device)


if __name__ == "__main__":
    main()
