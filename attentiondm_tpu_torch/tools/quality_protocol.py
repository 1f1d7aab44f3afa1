"""The end-to-end quantization quality ladder (port of
`attentiondm_tpu/tools/quality_protocol.py`).

What it measures on one set of weights (trained ones: `tools/train_synthetic.py`):

- **teacher-forced per-step eps-MSE**: each quantized model run on the FP32
  sampler's own trajectory inputs x_t, its eps against the FP32 one step by
  step, relative to mean eps^2 (`rel_eps_mse`);
- **free-running final-image PSNR**: each quantized sampler from the same
  x_T, its final images against the FP32 run's (data range 2.0, clipped to
  [-1, 1]);
- with `kid`, the random-feature KID proxy of each row's samples against the
  FP32 samples (`kid_proxy`, features of a seeded random `InceptionV3FID`;
  comparable only within one run).

Rows: W8A8 / W6A6 / W4A8 fake-quant at stage 1 and stage 1+2, the int8
serving path through the CUDA kernels (f32 and bf16 residual streams), the
bf16 compute path, and with `--adaround` the weight-quality ladder (bias
correction, AdaRound, GPTQ, per-step refinement, step-shared rank-1 folds,
serving-matched stage 2).

    python3 -m attentiondm_tpu_torch.tools.quality_protocol --ckpt exp/synthetic_ckpt.npz \\
        [--steps 100] [--batch 64] [--calib_batch 8] [--bits 8:8,4:8] [--kid] [--adaround --weight_rows gptq]

It runs on the current CUDA device (`run_protocol(device="cpu")` for the
CPU).  Draws come from torch.Generators seeded from `seed` (JAX splits a
PRNGKey); `x_init=`, `x_cal=` and `stage2_noise=` hand in other draws.
Unlike JAX's, the `--stage2_teacher` row also runs on the `--weight_rows gptq`
leg (JAX's raises NameError there; the `ar` leg skips it in both), and the
Gram batch is printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from .. import default_device
from ..diffusion.sampling import _seq_alphas, ddim_sample, make_timestep_seq
from ..diffusion.schedules import DiffusionSchedule
from ..models.unet import UNetConfig, cast_params, unet_apply, unet_init
from ..ops.precision import exact_f32
from ..quant.calibrate import calibrate_differentiable, calibrate_ranges
from ..quant.qunet import QuantizedUNet, make_quant_conv_apply


def kid_proxy(feats_a, feats_b) -> float:
    """Unbiased KID (MMD^2, polynomial kernel (x.y/d + 1)^3) between two
    feature sets, each dimension standardized against the reference set
    (`feats_b`) and the z-scores clipped to [-5, 5], so that features of a
    random CNN, whose scale may collapse, keep their relative variation.
    Only comparisons within one run (one feature network) are meaningful."""
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    mu = b.mean(axis=0)
    sd = b.std(axis=0)
    sd = np.maximum(sd, 1e-6 * (sd.mean() + 1e-300))
    a = np.clip((a - mu) / sd, -5.0, 5.0)
    b = np.clip((b - mu) / sd, -5.0, 5.0)
    d = a.shape[1]
    m, n = a.shape[0], b.shape[0]

    def k(x, y):
        return (x @ y.T / d + 1.0) ** 3

    kaa = k(a, a)
    kbb = k(b, b)
    kab = k(a, b)
    t_aa = (kaa.sum() - np.trace(kaa)) / (m * (m - 1))
    t_bb = (kbb.sum() - np.trace(kbb)) / (n * (n - 1))
    t_ab = kab.mean()
    return float(t_aa + t_bb - 2 * t_ab)


@torch.no_grad()
def calibrate_naive_tensorwise(qunet: QuantizedUNet, params, qstates, xs_in, seq):
    """Stage-0 baseline: per-step per-TENSOR min/max ranges (no LAPQ
    shrink, no groups, no per-channel structure) written into every group
    of each layer's `group_ranges`."""
    t_rev = np.asarray(list(seq))[::-1]
    new_states = dict(qstates)
    per_step = []
    with exact_f32():
        for i in range(xs_in.shape[0]):
            t_vec = torch.full((xs_in.shape[1],), float(t_rev[i]), dtype=torch.float32, device=xs_in.device)
            collect = {}
            unet_apply(params, qunet.cfg, xs_in[i], t_vec,
                       conv_apply=make_quant_conv_apply({}, qunet.policy, 0, mode="collect", collect=collect))
            per_step.append(collect)
    for name, st in qstates.items():
        gr = st.group_ranges.clone()
        for i in range(xs_in.shape[0]):
            cmin, cmax = per_step[i][name]
            gr[i, :, 0] = cmin.min()
            gr[i, :, 1] = cmax.max()
        new_states[name] = dataclasses.replace(st, group_ranges=gr)
    return new_states


def _dump_live(tag: str) -> None:
    """The device's allocated and peak memory (the ladder's OOM tool)."""
    if not torch.cuda.is_available():
        return
    print(f"LIVE[{tag}] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak", flush=True)


def psnr(a, b, data_range: float = 2.0) -> float:
    """PSNR between two image batches clipped to the data domain."""
    a = torch.clamp(a, -1.0, 1.0)
    b = torch.clamp(b, -1.0, 1.0)
    mse = float(torch.mean(torch.square(a - b)))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


@torch.no_grad()
def _eps_scan(model_fn, xs_in, t_rev):
    """[S, N, H, W, C]: the model's eps at each step's input of a fixed trajectory."""
    return torch.stack([model_fn(xs_in[i], torch.full((xs_in.shape[1],), float(t_rev[i]), dtype=torch.float32,
                                                      device=xs_in.device), i)
                        for i in range(xs_in.shape[0])])


def rel_eps_mse(eps_q, eps_ref):
    """Per-step relative eps-MSE: mean((q - ref)^2) / mean(ref^2), [S]."""
    num = torch.mean(torch.square(eps_q - eps_ref), dim=(1, 2, 3, 4))
    den = torch.mean(torch.square(eps_ref), dim=(1, 2, 3, 4))
    return num / den


def gram_batch(calib_batch: int, resolution: int) -> int:
    """The calibration images the Gram / AdaRound collection takes: it holds
    [B*H*W, K] patches a layer, so above 32^2 the batch is capped at 32^2's
    patch volume (JAX's cap).  The batch used is printed (JAX's is silent)."""
    gram_b = max(1, min(calib_batch, (calib_batch * 1024) // resolution**2))
    print(f"Gram batch: {gram_b} of the {calib_batch} calibration images at {resolution}^2"
          + (" (capped to 32^2's patch volume)" if gram_b < calib_batch else ""), flush=True)
    return gram_b


def _generator(device, seed: int, tag: int):
    """The generator of one of the ladder's draws: `tag` 0 x_T, 1 the
    calibration batch, 7 / 8 / 9 the stage-2 runs (JAX's fold_in tags)."""
    return torch.Generator(device=device).manual_seed(seed * 1000 + tag)


def run_protocol(
    params,
    cfg: UNetConfig,
    *,
    steps: int = 100,
    skip_type: str = "quad",
    batch: int = 64,
    calib_batch: int = 8,
    seed: int = 0,
    bit_configs=((8, 8), (6, 6), (4, 8)),
    stage2: bool = True,
    serving: bool = True,
    bf16: bool = True,
    stage0: bool = False,
    attribution: bool = False,
    kid: bool = False,
    stage2_lr: float = 0.05,
    stage2_epochs: int = 1,
    adaround: bool = False,
    adaround_iters: int = 600,
    stage2_teacher: bool = False,
    shared: bool = False,
    weight_rows: str = "all",
    x_init=None,
    x_cal=None,
    stage2_noise=None,
    on_row=None,
    device=None,
):
    """Returns {row_name: {"eps_rel_mse_mean", "eps_rel_mse_max", "psnr"[, "kid"]}}.

    Row names: fp32 (the reference, PSNR inf), bf16, w{W}a{A}_s0 and _s1nf
    (`stage0`: naive per-tensor ranges; stage 1 without the [-4, 6] range
    floor), w{W}a{A}_s1, _s12t (`stage2_teacher`), _s12 / _s12g / _s12e{n}
    (`stage2`), int8_w4a8 (+ _bf16res and, with `adaround`, the weight
    ladder's rows), and with `attribution` w4only / w16a8_s1.

    `x_init` [batch, H, W, C] and `x_cal` [calib_batch, H, W, C] are the
    evaluation and calibration noise; `stage2_noise` {7, 8, 9: [epochs, S,
    calib_batch, H, W, C]} the stage-2 runs' (`calibrate_differentiable`'s
    `noise=`).  Each is drawn from a generator seeded from `seed` where not
    given.  `on_row(name, row)` is called as each row lands."""
    device = default_device() if device is None else torch.device(device)
    sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=device)
    seq = make_timestep_seq(1000, steps, skip_type)
    t_rev, _, _, _ = _seq_alphas(sched.betas, seq)
    shape = (cfg.resolution, cfg.resolution, cfg.in_channels)
    if x_init is None:
        x_init = torch.randn((batch,) + shape, generator=_generator(device, seed, 0), device=device)
    if x_cal is None:
        x_cal = torch.randn((calib_batch,) + shape, generator=_generator(device, seed, 1), device=device)
    x_init, x_cal = torch.as_tensor(x_init, device=device), torch.as_tensor(x_cal, device=device)

    def fp_fn(xt, t, i):
        return unet_apply(params, cfg, xt, t)

    @torch.no_grad()
    def trajectory(fn, x):
        """(final x, the model's input at each step [S, N, H, W, C])."""
        xf, traj, _ = ddim_sample(fn, x, seq, sched.betas, keep_trajectory=True)
        return xf, torch.cat([x[None], traj[:-1]], dim=0)

    def stage2_draws(tag):
        if stage2_noise is not None:
            return dict(noise=torch.as_tensor(stage2_noise[tag], device=device))
        return dict(generator=_generator(device, seed, tag))

    # the FP32 teacher: free run, trajectory inputs, reference eps; then the calibration trajectory
    with exact_f32():
        x_fp, xs_in = trajectory(fp_fn, x_init)
        eps_ref = _eps_scan(fp_fn, xs_in, t_rev)
        imgs_cal, xs_cal = trajectory(fp_fn, x_cal)

    rows = {"fp32": dict(eps_rel_mse_mean=0.0, eps_rel_mse_max=0.0, psnr=float("inf"))}

    extract = None
    feats_fp = None
    if kid:
        from ..eval.inception import InceptionV3FID

        inc = InceptionV3FID.random(seed=0, device=device)

        def extract(imgs):
            return inc.extract(torch.clamp((imgs + 1.0) * 0.5, 0.0, 1.0)).cpu().numpy()

        feats_fp = extract(x_fp)
        rows["fp32"]["kid"] = 0.0
    if on_row is not None:
        on_row("fp32", rows["fp32"])

    def add_row(name, eps_q, x_final):
        r = rel_eps_mse(eps_q, eps_ref)
        rows[name] = dict(eps_rel_mse_mean=float(r.mean()), eps_rel_mse_max=float(r.max()),
                          psnr=psnr(x_final, x_fp))
        if extract is not None:
            rows[name]["kid"] = kid_proxy(extract(x_final), feats_fp)
        print("ROW", name, json.dumps(rows[name]), flush=True)  # incremental: a long ladder keeps what it computed
        if on_row is not None:
            on_row(name, rows[name])

    @torch.no_grad()
    def run(fn):
        """(the eps scan over the teacher's inputs, the free run from x_init) of one eps model: `add_row`'s."""
        with exact_f32():
            return _eps_scan(fn, xs_in, t_rev), ddim_sample(fn, x_init, seq, sched.betas)

    # the bf16 compute path
    if bf16:
        p_b = cast_params(params, torch.bfloat16)
        add_row("bf16", *run(lambda xt, t, i: unet_apply(p_b, cfg, xt, t, compute_dtype=torch.bfloat16)))
        del p_b

    # attribution: 4-bit weights with float activations
    if attribution:
        qp4, _ = QuantizedUNet.create(cfg, bitwidth=4, a_bitwidth=8).prepare_params(params)
        add_row("w4only", *run(lambda xt, t, i: unet_apply(qp4, cfg, xt, t)))
        del qp4
    if attribution and (16, 8) not in tuple(bit_configs):
        bit_configs = tuple(bit_configs) + ((16, 8),)

    # the fake-quant configs
    for w_bit, a_bit in bit_configs:
        qunet = QuantizedUNet.create(cfg, bitwidth=w_bit, a_bitwidth=a_bit)
        with exact_f32(), torch.no_grad():
            qstates = calibrate_ranges(qunet, params, qunet.init_state(steps, device), xs_cal, seq, first=True)
        qparams, _ = qunet.prepare_params(params)

        def run_q(qs, qunet=qunet, qparams=qparams):
            return run(qunet.model_fn(qparams, qs, mode="infer"))

        tag = f"w{w_bit}a{a_bit}"
        if stage0:
            qs0 = calibrate_naive_tensorwise(qunet, params, qunet.init_state(steps, device), xs_cal, seq)
            add_row(f"{tag}_s0", *run_q(qs0))
            # stage 1 without the reference's [-4, 6] range floor: pure data-driven group ranges
            q_nf = QuantizedUNet(cfg=qunet.cfg, policy={n: dataclasses.replace(p, init_min=0.0, init_max=1e-6)
                                                        for n, p in qunet.policy.items()})
            with exact_f32(), torch.no_grad():
                qs_nf = calibrate_ranges(q_nf, params, q_nf.init_state(steps, device), xs_cal, seq, first=True)
            add_row(f"{tag}_s1nf", *run_q(qs_nf))
            del qs0, qs_nf

        add_row(f"{tag}_s1", *run_q(qstates))

        eps_cal_ref = None  # the FP teacher's eps over xs_cal, computed at most once
        if stage2_teacher:
            from ..quant.calibrate import calibrate_teacher_matched

            with exact_f32():
                eps_cal_ref = _eps_scan(fp_fn, xs_cal, t_rev)
                qstates_tm, _ = calibrate_teacher_matched(qunet, qparams, qstates, xs_cal, eps_cal_ref, seq,
                                                          lr=0.02, epochs=8)
            add_row(f"{tag}_s12t", *run_q(qstates_tm))
            del qstates_tm

        if stage2:
            def s2(tag_id, **kw):
                return calibrate_differentiable(qunet, params, qstates, imgs_cal, seq, sched.betas, lr=stage2_lr,
                                                **stage2_draws(tag_id), **kw)[0]

            add_row(f"{tag}_s12", *run_q(s2(7, attention_focus=True)))  # the attention-focused selection
            add_row(f"{tag}_s12g", *run_q(s2(8, attention_focus=False)))  # all convs, for scale
            if stage2_epochs > 1:
                add_row(f"{tag}_s12e{stage2_epochs}", *run_q(s2(9, attention_focus=False, epochs=stage2_epochs)))

        if serving and (w_bit, a_bit) == (4, 8):
            _serving_ladder(rows, add_row, qunet, params, qstates, cfg, seq, sched, x_init, xs_in, xs_cal, fp_fn,
                            t_rev, eps_cal_ref, calib_batch=calib_batch, adaround=adaround,
                            adaround_iters=adaround_iters, stage2_teacher=stage2_teacher, shared=shared,
                            weight_rows=weight_rows)
        del qstates, qparams
    return rows


def _serving_ladder(rows, add_row, qunet, params, qstates, cfg, seq, sched, x_init, xs_in, xs_cal, fp_fn, t_rev,
                    eps_cal_ref, *, calib_batch, adaround, adaround_iters, stage2_teacher, shared, weight_rows):
    """The W4A8 rows served through the CUDA kernels (`attn_int8=False`):
    int8_w4a8 at the f32 and bf16 residual streams, then with `adaround`
    the weight ladder, leg by leg (`weight_rows` "ar", "gptq" or "all")."""
    from ..quant.int8_serving import prepare_serving_runtime, serving_ddim_sampler, serving_unet_apply

    def serving_row(suffix, qs, extras, res_dtype, rank1=False):
        # one fold a row, shared by the sampler and the eps scan, freed before the next row's
        runtime = prepare_serving_runtime(qunet, params, qs, weight_extras=extras, rank1=rank1)
        sample = serving_ddim_sampler(qunet, params, qs, seq, sched.betas, residual_dtype=res_dtype,
                                      attn_int8=False, weight_extras=extras, rank1=rank1, runtime=runtime)
        with torch.no_grad():
            xf_s = sample(x_init)
            eps_s = _eps_scan(lambda x, t, i: serving_unet_apply(params, cfg, qunet, runtime, qs, x, t, i,
                                                                 residual_dtype=res_dtype, attn_int8=False),
                              xs_in, t_rev)
        add_row(f"int8_w4a8{suffix}", eps_s, xf_s)
        del sample, runtime, xf_s, eps_s
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    serving_row("", qstates, None, torch.float32)
    serving_row("_bf16res", qstates, None, torch.bfloat16)
    if not adaround:
        return

    from ..quant.adaround import WeightExtras, compute_weight_extras
    from ..quant.calibrate import refine_weight_extras

    gram_b = gram_batch(calib_batch, cfg.resolution)
    xs_gram = xs_cal[:, :gram_b]
    if eps_cal_ref is None:
        with exact_f32():
            eps_cal_ref = _eps_scan(fp_fn, xs_cal, t_rev)

    def refine(extras, rank1=False):
        with exact_f32():
            return refine_weight_extras(qunet, params, qstates, extras, xs_cal, eps_cal_ref, seq, per_step=True,
                                        rank1=rank1)[0]

    def adaround_extras():
        with exact_f32():
            return compute_weight_extras(qunet, params, qstates, xs_gram, seq, iters=adaround_iters)

    extras = None  # the AdaRound extras, which the serving-matched stage 2 below also serves
    if weight_rows in ("all", "ar"):
        extras = adaround_extras()
        extras_bc = {n: WeightExtras(round_offset=None, mu=e.mu) for n, e in extras.items()}
        serving_row("_bc", qstates, extras_bc, torch.float32)
        serving_row("_ar", qstates, extras, torch.float32)
        serving_row("_ar_bf16res", qstates, extras, torch.bfloat16)
        # per-step fold refinement on top of AdaRound
        extras_ps = refine(extras)
        serving_row("_ar_refine", qstates, extras_ps, torch.float32)
        serving_row("_ar_refine_bf16res", qstates, extras_ps, torch.bfloat16)
        del extras_ps, extras_bc
        if not (stage2_teacher and weight_rows == "all"):
            extras = None

    if weight_rows in ("all", "gptq"):
        _dump_live("before gptq extras")
        with exact_f32():
            extras_g = compute_weight_extras(qunet, params, qstates, xs_gram, seq, method="gptq")
        serving_row("_gptq", qstates, extras_g, torch.float32)
        serving_row("_gptq_refine", qstates, refine(extras_g), torch.float32)
        del extras_g
        if shared:
            # the step-shared rank-1 fold, before and after the per-step refinement
            with exact_f32():
                extras_sh = compute_weight_extras(qunet, params, qstates, xs_gram, seq, method="gptq", rank1=True)
            serving_row("_gptq_shared", qstates, extras_sh, torch.float32, rank1=True)
            serving_row("_gptq_refine_shared", qstates, refine(extras_sh, rank1=True), torch.float32, rank1=True)
            del extras_sh

    if stage2_teacher and weight_rows in ("all", "gptq"):
        # serving-matched stage 2 on top of AdaRound, its ranges optimized through the exact fold; on the gptq
        # leg the AdaRound extras are made here (JAX's protocol reads the AR leg's, which that leg lacks)
        from ..quant.calibrate import calibrate_teacher_matched

        if extras is None:
            extras = adaround_extras()
        with exact_f32():
            qstates_srv, _ = calibrate_teacher_matched(qunet, params, qstates, xs_cal, eps_cal_ref, seq, lr=0.02,
                                                       epochs=8, serving_extras=extras)
        serving_row("_ar_s2srv", qstates_srv, extras, torch.float32)


def format_table(rows) -> str:
    has_kid = any("kid" in r for r in rows.values())
    hdr = "| config | eps rel-MSE (mean) | eps rel-MSE (max) | final PSNR vs FP32 (dB) |"
    sep = "|---|---|---|---|"
    if has_kid:
        hdr += " KID-proxy (x1e3) |"
        sep += "---|"
    lines = [hdr, sep]
    for name, r in rows.items():
        p = "inf" if np.isinf(r["psnr"]) else f"{r['psnr']:.1f}"
        line = f"| {name} | {r['eps_rel_mse_mean']:.6g} | {r['eps_rel_mse_max']:.6g} | {p} |"
        if has_kid:
            line += f" {1e3 * r['kid']:.3f} |" if "kid" in r else " - |"
        lines.append(line)
    return "\n".join(lines)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="the quantization quality ladder")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="EMA npz from tools/train_synthetic.py (random init if absent)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--calib_batch", type=int, default=8)
    ap.add_argument("--skip_type", type=str, default="quad")
    ap.add_argument("--json_out", type=str, default=None)
    ap.add_argument("--no_stage2", action="store_true")
    ap.add_argument("--no_serving", action="store_true")
    ap.add_argument("--stage0", action="store_true", help="add naive per-tensor-range baseline rows")
    ap.add_argument("--attribution", action="store_true", help="add weight-only / act-only isolation rows")
    ap.add_argument("--kid", action="store_true", help="add random-feature KID proxy vs the FP32 samples")
    ap.add_argument("--stage2_epochs", type=int, default=1, help=">1 adds a multi-epoch stage-2 row")
    ap.add_argument("--adaround", action="store_true", help="add bias-correction / AdaRound serving rows")
    ap.add_argument("--adaround_iters", type=int, default=600)
    ap.add_argument("--stage2_teacher", action="store_true", help="add teacher-matched stage-2 rows (_s12t)")
    ap.add_argument("--shared", action="store_true",
                    help="add step-SHARED rank-1 fold rows (_gptq_shared / _gptq_refine_shared); requires --adaround")
    ap.add_argument("--bits", type=str, default=None,
                    help="restrict bit configs, e.g. '8:8,4:8' (default: 8:8, 6:6, 4:8)")
    ap.add_argument("--config", type=str, default=None,
                    help="config YAML overriding the CIFAR-10 UNetConfig (e.g. celeba.yml)")
    ap.add_argument("--weight_rows", default="all", choices=("all", "ar", "gptq"),
                    help="split the --adaround weight ladder into independently runnable legs")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = default_device() if args.device is None else torch.device(args.device)
    cfg = UNetConfig()
    if args.config:
        from ..config import load_config

        cfg = UNetConfig.from_config(load_config(args.config))
    params = unet_init(torch.Generator().manual_seed(0), cfg, device)
    weights = "random-init"
    if args.ckpt:
        from ..checkpoint import load_checkpoint

        params = load_checkpoint(args.ckpt, params, device=device)  # the raw EMA tree
        weights = f"trained ({args.ckpt})"
    kw = {}
    if args.bits:
        kw["bit_configs"] = tuple(tuple(int(b) for b in part.split(":")) for part in args.bits.split(","))
    rows = run_protocol(
        params, cfg, steps=args.steps, skip_type=args.skip_type, batch=args.batch, calib_batch=args.calib_batch,
        stage2=not args.no_stage2, serving=not args.no_serving, stage0=args.stage0,
        attribution=args.attribution, kid=args.kid, stage2_epochs=args.stage2_epochs, adaround=args.adaround,
        adaround_iters=args.adaround_iters, stage2_teacher=args.stage2_teacher, shared=args.shared,
        weight_rows=args.weight_rows, device=device, **kw,
    )
    print(f"weights: {weights}; DDIM-{args.steps} ({args.skip_type}), batch {args.batch}")
    print(format_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"weights": weights, "rows": rows}, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
