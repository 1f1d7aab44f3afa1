"""GPTQ on imagenet64's widest layers, on the card (port of
`attentiondm_tpu/tools/gptq_imagenet64_probe.py`).

imagenet64's widest up-block conv1 reads K = 9 x 2048 = 18432 rows (the
1024 + 1024 skip concat); `quant.adaround.GRAM_K_MAX` is 18432, and GPTQ's
compensation is blocked (quant/gptq.py).  On the real pipeline at the
config's width this probe reports JAX's four rows:
  1. no round-to-nearest fallback advisory fires on any layer;
  2. the layers of the largest K get integer rounding offsets, with their
     spread on the largest (GPTQ moves weights several levels; AdaRound's
     offsets are 0 / 1);
  3. the Gram-weighted output-space quadratic error of that layer's W4
     fold, round-to-nearest against GPTQ (the objective GPTQ minimizes);
  4. the W4A8 serving forward's eps at the last step of a 2-step schedule,
     RTN fold against GPTQ fold, as relative MSE against the FP32 teacher's.
The 80 GB card holds what the TPU's 16 GB could not (its Grams and the
fold of every layer).

    python3 -m attentiondm_tpu_torch.tools.gptq_imagenet64_probe [--steps 2] [--batch 2]
        [--config imagenet64.yml] [--device cpu] [--out FILE.json]
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from ..config import load_config
from ..models.unet import UNetConfig, count_params, iter_conv_layers, lookup, unet_apply, unet_init
from ..ops.precision import exact_f32
from ..ops.quant_conv import weight_grid
from ..quant.adaround import GRAM_K_MAX, collect_conv_stats, compute_weight_extras
from ..quant.state import mixed_ranges
from . import probe


def trajectory(cfg, params, steps: int, batch: int, device, seed: int = 1):
    """(seq, betas, the FP teacher's model inputs [S, batch, H, W, C])."""
    from ..diffusion.sampling import ddim_sample, make_timestep_seq
    from ..diffusion.schedules import DiffusionSchedule

    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=device).betas
    seq = make_timestep_seq(1000, steps, "quad")
    x0 = probe.images(cfg, batch, seed, device)
    with torch.no_grad():
        _, traj, _ = ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x0, seq, betas,
                                 keep_trajectory=True)
    return seq, betas, torch.cat([x0[None], traj[:-1]])


@exact_f32()
@torch.no_grad()
def quad_errors(cfg, params, qstates, extras, xs, seq, steps: int, name: str):
    """(RTN's, GPTQ's) Gram-weighted quadratic error of layer `name`'s W4
    fold: sum d (H d) over the output channels, d the folded weights' error,
    H the layer's input Gram over the trajectory, per row."""
    kernel = lookup(params, name)["kernel"]
    kh, kw, ci, co = kernel.shape
    K = kh * kw * ci
    stats = collect_conv_stats(params, cfg, xs, seq, max_steps=steps, names=[name], k_cap=K)[name]
    n_lv = 2 ** 8 - 1

    def at(s):
        rmin, rmax = mixed_ranges(qstates[name], s)
        return n_lv / (rmax - rmin)

    scale = torch.stack([at(s) for s in range(steps)]).mean(dim=0)
    g = (kernel / scale.reshape(1, 1, ci, 1)).reshape(K, co)
    ws, wzp = weight_grid(g, 4, True, torch.broadcast_to(extras[name].shrink, (co,)))
    H = stats.gram / torch.clamp(stats.count, min=1.0)
    base = ws[None] * g - wzp[None]
    rtn = torch.clamp(torch.round(base), -8, 7)
    gptq = torch.clamp(torch.floor(base) + extras[name].round_offset.reshape(-1, co).to(base.dtype), -8, 7)

    def quad(q):
        d = (q + wzp[None]) / ws[None] - g
        return float(torch.sum(d * (H @ d)))

    return quad(rtn), quad(gptq)


def weight_report(cfg, params, qunet, qstates, xs, seq, steps: int):
    """(GPTQ extras, rows 1 to 3): the advisories, the offsets of the layers
    at the largest K and their spread, the quadratic errors."""
    advisories = []

    class Keep(logging.Handler):
        def emit(self, rec):
            if "exceeds k_max" in rec.getMessage():
                advisories.append(rec.getMessage())

    h = Keep()
    logging.getLogger().addHandler(h)
    try:
        t0 = time.perf_counter()
        extras = compute_weight_extras(qunet, params, qstates, xs, seq, max_steps=steps, method="gptq")
        seconds = time.perf_counter() - t0
    finally:
        logging.getLogger().removeHandler(h)
    k_of = {n: k * k * c for n, c, k in iter_conv_layers(cfg)}
    k_top = max(k_of[n] for n in extras)
    big = [n for n in extras if k_of[n] == k_top]
    name = big[0]
    off = extras[name].round_offset
    rep = {"advisories": advisories, "gram_k_max": GRAM_K_MAX, "weight_pass_s": seconds,
           "n_layers": len(extras), "n_layers_with_offsets": sum(1 for e in extras.values()
                                                                   if e.round_offset is not None),
           "k_top": k_top, "k_top_layers": len(big),
           "k_top_with_offsets": sum(1 for n in big if extras[n].round_offset is not None), "largest_layer": name}
    if off is not None:
        rep["offset_min_max"] = [int(off.min()), int(off.max())]
        rep["offset_nonzero_frac"] = float((off != 0).float().mean())
        e_rtn, e_gptq = quad_errors(cfg, params, qstates, extras, xs, seq, steps, name)
        rep.update(quad_err_rtn=e_rtn, quad_err_gptq=e_gptq, gptq_vs_rtn=e_gptq / max(e_rtn, 1e-30))
    return extras, rep


@torch.no_grad()
def serving_report(cfg, params, qunet, qstates, extras, xs, seq, steps: int):
    """Row 4: the served eps's relative MSE against the FP32 teacher's, RTN
    fold and GPTQ fold (the last input, JAX's timestep and step index)."""
    from ..quant.int8_serving import prepare_serving_runtime, serving_model_fn

    t = torch.full((xs.shape[1],), float(int(seq[-1])), device=xs.device)
    eps_fp = unet_apply(params, cfg, xs[-1], t)
    out = {}
    for label, ex in (("rtn", None), ("gptq", extras)):
        rt = prepare_serving_runtime(qunet, params, qstates, weight_extras=ex)
        eps = serving_model_fn(qunet, rt, params, qstates, attn_int8=False)(xs[-1], t, steps - 1)
        out[f"eps_rel_mse_{label}"] = float(torch.mean((eps - eps_fp) ** 2) / torch.mean(eps_fp ** 2))
        del rt
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--config", default="imagenet64.yml", help="the model (imagenet64's by default)")
    args = probe.add_common(ap).parse_args(argv)
    device = probe.device_of(args.device)
    from ..quant.calibrate import calibrate_ranges
    from ..quant.qunet import QuantizedUNet

    cfg = UNetConfig.from_config(load_config(args.config))
    params = unet_init(torch.Generator().manual_seed(0), cfg, device)
    seq, _betas, xs = trajectory(cfg, params, args.steps, args.batch, device)
    qunet = QuantizedUNet.create(cfg, bitwidth=4, a_bitwidth=8)
    qstates = calibrate_ranges(qunet, params, qunet.init_state(args.steps, device), xs, seq, first=True)
    extras, rep = weight_report(cfg, params, qunet, qstates, xs, seq, args.steps)
    if rep["advisories"]:
        raise AssertionError(f"round-to-nearest fallback fired: {rep['advisories']}")
    if rep["k_top_with_offsets"] != rep["k_top_layers"]:
        raise AssertionError(f"layers at K = {rep['k_top']} without offsets: {rep}")
    rep.update(serving_report(cfg, params, qunet, qstates, extras, xs, seq, args.steps))
    rep["params_m"] = count_params(params) / 1e6
    if device.type == "cuda":
        rep["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"{rep['largest_layer']} (K = {rep['k_top']}): quad err GPTQ / RTN = {rep.get('gptq_vs_rtn')}; serving "
          f"eps rel-MSE rtn {rep['eps_rel_mse_rtn']:.4f} gptq {rep['eps_rel_mse_gptq']:.4f}")
    return probe.emit("gptq_imagenet64_probe", device, args, rep, args.out)


if __name__ == "__main__":
    main()
