"""What the Hopper probes share (`conv_roofline`, `conv_attack_probe`,
`perf_probe_int8`, `step_breakdown`, `ab_serving_levers`,
`bench_enhanced_mp`, `gptq_imagenet64_probe`): the device, the card's name
and power limit, CUDA-event timing (a kernel's device time behind a spin
kernel, `device_ms`; a sampler run's between events, `event_ms`) and the
JSON record.

A probe runs on the current CUDA device, or on the CPU where the caller
asks for it (`--device cpu`, as the tests do): there every computation
runs once through the kernels' plain versions and checks what it can, and
every time is null ("not measured"): a CPU run gives no device figure.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from .. import default_device


def add_common(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device; cpu: the plain "
                                                   "versions once, no times)")
    ap.add_argument("--out", default=None, help="also write the JSON record to this file")
    return ap


def device_of(name) -> torch.device:
    """The probe's device: the current CUDA device unless `name` says
    otherwise; no card and no request for the CPU raises."""
    return default_device() if name is None else torch.device(name)


def card(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them (the CPU: its name only)."""
    if device.type != "cuda":
        return {"name": "cpu", "nvidia_smi": None}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": line}


SPIN_CYCLES = 40_000_000  # about 20 ms of torch.cuda._sleep at the H100's clocks (`device_ms`)


def device_ms(fn, reps: int = 20) -> float:
    """Device time in ms of one call of `fn`, the wrapper's host time left
    out: CUDA events around `reps` calls that the host enqueues while the card
    still runs a spin kernel, so the card then runs them back to back.  An
    event behind the spin kernel that has not completed when the last call is
    enqueued shows that every call waited on the card; if it has, the spin is
    made four times as long and the measurement taken again.  The figure
    holds everything the wrapper launches: its own kernels and any small
    torch kernels around them."""
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


def kernel_ms(fn, device: torch.device, reps: int = 20):
    """A kernel's (or a short call's) device time in ms (`device_ms`); on
    the CPU `fn` runs once and the time is None."""
    if device.type != "cuda":
        fn()
        return None
    return device_ms(fn, reps)


def event_ms(fn, device: torch.device, reps: int = 10, warm: int = 1):
    """Median ms of one call of `fn` on the card, the host's time included
    (a sampler run): CUDA events around each call, each ending on a device
    sync, after `warm` calls.  On the CPU `fn` runs once and the time is None."""
    if device.type != "cuda":
        fn()
        return None
    for _ in range(warm):
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


def interleaved(fns: dict, device: torch.device, rounds: int = 3, timer=None) -> dict:
    """{name: [ms of each round]}: every variant timed once a round, in
    turns, so drift over the run hits all of them alike; `timer(fn)` (by
    default one call between CUDA events: warm each before).  The CPU: one
    call each, no times."""
    timer = timer or (lambda fn: event_ms(fn, device, reps=1, warm=0))
    out = {name: [] for name in fns}
    for _ in range(rounds if device.type == "cuda" else 1):
        for name, fn in fns.items():
            out[name].append(timer(fn) if device.type == "cuda" else (fn(), None)[1])
    return out


def median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emit(probe: str, device: torch.device, args, record: dict, out: str | None = None) -> dict:
    """The probe's JSON record: its name, its arguments, the card's name and
    power limit beside the numbers; printed on one line (and written to
    `out`)."""
    rec = {"probe": probe, "card": card(device), "device": str(device), "torch": torch.__version__,
           "args": {k: v for k, v in vars(args).items() if k not in ("out",)}, **record}
    print(json.dumps(rec))
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def calibrated(cfg, steps: int, device, *, seed: int = 0, calib_images: int = 2, params=None):
    """The headline operating point's model (as JAX's probes build it):
    seeded params (or `params`), the linear schedule, DDIM `steps` quad
    steps, the FP teacher's trajectory on `calib_images` images and stage-1
    W4A8 ranges on it.  Returns (params, qunet, qstates, seq, betas)."""
    from ..diffusion.sampling import ddim_sample, make_timestep_seq
    from ..diffusion.schedules import DiffusionSchedule
    from ..models.unet import unet_apply, unet_init
    from ..quant.calibrate import calibrate_ranges
    from ..quant.qunet import QuantizedUNet

    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = unet_init(gen, cfg, device)
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=device).betas
    seq = make_timestep_seq(1000, steps, "quad")
    x = torch.randn((calib_images, cfg.resolution, cfg.resolution, cfg.in_channels), generator=gen).to(device)
    with torch.no_grad():
        _, traj, _ = ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x, seq, betas,
                                 keep_trajectory=True)
    xs_in = torch.cat([x[None], traj[:-1]])
    qunet = QuantizedUNet.create(cfg, bitwidth=4, a_bitwidth=8)
    qstates = calibrate_ranges(qunet, params, qunet.init_state(steps, device), xs_in, seq, first=True)
    return params, qunet, qstates, seq, betas


def images(cfg, n: int, seed: int, device):
    """n seeded standard-normal images of the config's shape, on `device`."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, cfg.resolution, cfg.resolution, cfg.in_channels), generator=g).to(device)
