"""Serving-step cost breakdown at the headline operating point, on the card
(port of `attentiondm_tpu/tools/step_breakdown.py`).

Times the W4A8 CIFAR-10 serving sampler (batch 128, DDIM-100 quad, the
bf16 residual stream, the f32 attention core: bench.py's flags), then the
same sampler with one component stubbed out, all in one process, the
variants timed in turns (`--rounds`), each run between CUDA events ending on
a device sync.  The deltas attribute the step's time:
  - attn=identity        every attention block returns its input;
  - entry=quantize-only  the GroupNorm entries (K4, or plain torch) only
                         quantizes (no statistics, no normalize);
  - epilogue=plain       the resblock epilogue (K2 / K6) is replaced by its
                         plain torch version, called directly: a timing
                         instrument, not the serving route;
  - unet=identity        the whole UNet is x -> x (the DDIM update and the
                         launch floor).
The stubs change the numbers, not the shapes.

    python3 -m attentiondm_tpu_torch.tools.step_breakdown [--batch 128] [--steps 100] [--rounds 2]
        [--ch 128] [--device cpu] [--out FILE.json]
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from ..diffusion.sampling import _seq_alphas, ddim_step
from ..models.unet import UNetConfig
from ..ops import fused_gn
from ..ops.fused_gn import quant_i8
from ..quant import int8_serving as srv
from . import probe

VARIANTS = ("full", "attn=identity", "entry=quantize-only", "epilogue=plain", "unet=identity")


def _entry_stub(h_res, gn_p, quant_params, *, act="swish", sums=None, eps=fused_gn.GN_EPS, plain=False):
    hf = h_res.to(torch.float32)
    return tuple(quant_i8(hf, s, z, b) for (s, z, b) in quant_params)


def _epilogue_stub(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp, a_bit, *, eps=fused_gn.GN_EPS,
                   plain=False):
    return fused_gn.epilogue_gn_swish_quant_ref(dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp,
                                                a_bit, eps)


@contextlib.contextmanager
def stubbed(variant: str):
    """The serving module with `variant`'s component replaced while it runs."""
    saved = srv._attn_fused, srv._entry_gn_quant, srv.epilogue_gn_swish_quant
    if variant == "attn=identity":
        srv._attn_fused = lambda name, p, h_res, *a, **k: h_res
    elif variant == "entry=quantize-only":
        srv._entry_gn_quant = _entry_stub
    elif variant == "epilogue=plain":
        srv.epilogue_gn_swish_quant = _epilogue_stub
    try:
        yield
    finally:
        srv._attn_fused, srv._entry_gn_quant, srv.epilogue_gn_swish_quant = saved


def identity_sampler(seq, betas):
    """The DDIM loop with eps = x: the update and the launch floor alone."""
    t_rev, _, at, at_next = _seq_alphas(betas, seq)

    def sample(x):
        for i in range(t_rev.shape[0]):
            x, _ = ddim_step(x, x, at[i], at_next[i], 0.0, torch.zeros_like(x))
        return x

    return sample


def build(cfg, steps: int, device):
    """{variant: run(x)}: the serving sampler under each stub, and the identity loop."""
    params, qunet, qstates, seq, betas = probe.calibrated(cfg, steps, device)
    sampler = srv.serving_ddim_sampler(qunet, params, qstates, seq, betas, residual_dtype=torch.bfloat16,
                                       attn_int8=False)

    def under(variant):
        def run(x):
            with stubbed(variant), torch.no_grad():
                return sampler(x)
        return run

    runs = {v: under(v) for v in VARIANTS if v != "unet=identity"}
    runs["unet=identity"] = identity_sampler(seq, betas)
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ch", type=int, default=128, help="the UNet's base width (CIFAR-10's 128)")
    args = probe.add_common(ap).parse_args(argv)
    device = probe.device_of(args.device)
    cfg = UNetConfig(ch=args.ch)
    runs = build(cfg, args.steps, device)
    x = probe.images(cfg, args.batch, 2, device)
    finite = {}
    for v, run in runs.items():  # warm-up, and the stubs change values, not finiteness
        finite[v] = bool(torch.isfinite(run(x)).all())
    times = probe.interleaved({v: (lambda run=run: run(x)) for v, run in runs.items()}, device, rounds=args.rounds)
    best = {v: min((t for t in ts if t is not None), default=None) for v, ts in times.items()}
    full = best["full"]
    rows = []
    for v in VARIANTS:
        ms = best[v]
        rows.append(dict(variant=v, ms=ms, img_per_s=None if ms is None else args.batch / (ms * 1e-3),
                         finite=finite[v], rounds=times[v],
                         delta_ms_per_step=None if ms is None or v == "full" else (full - ms) / args.steps))
        print(f"{v:22s} " + ("-" if ms is None else f"{ms:9.2f} ms/trajectory ({args.batch / (ms * 1e-3):7.1f} img/s)"
                                                    + ("" if v == "full" else
                                                       f"  delta {(full - ms) / args.steps:.4f} ms/step")))
    return probe.emit("step_breakdown", device, args, {"rows": rows, "full_ms_per_step": None if full is None
                                                        else full / args.steps}, args.out)


if __name__ == "__main__":
    main()
