#!/usr/bin/env python3
"""Device time of the GroupNorm kernels at every shape of the CIFAR-10 (batch
128), LSUN church (32), celeba-wide (64) and ImageNet-64 (32) serving steps:
K2 and K6 (`ops.fused_gn.epilogue_gn_swish_quant`) at every resblock
epilogue, and on CIFAR-10, church and ImageNet-64 with the three levers K4
(`gn_act_quant`) at every entry,
K7 (`epilogue_residual_gn_stats`) at every fused exit, K12
(`resblock_pallas`) at every whole block, and K3 (`fused_attention_block`,
whose first launch is K4's kernel) at every attention block.

    python3 attentiondm_tpu_torch/tools/gn_shapes.py [--out FILE.json] [--plans] [--only K2,K4,K7,...] [--paths a,b]

The port is imported from the current directory, not from beside this file,
so one script measures two trees on the same card, one after the other (run
it from the root of each; it needs `epilogue_gn_swish_quant(..., plain=)`,
`gn_act_quant`, `resblock_pallas`, `fused_attention_block`,
`ops.checks.conv_plan` / `lever_plan` and `chip_smoke.device_ms`, and prints
the launch plan where the tree has `ops.fused_gn.epilogue_plan` for the
kind).  Per shape, on inputs as the serving path gives them: the call's
device time (`chip_smoke.device_ms`: CUDA events around 20 calls queued
behind a busy card), whether the output equals the plain version's, and
the least time the card could take (bytes, each input read once and each
output written once, over 3.35 TB/s, or the operations over their peak; K12
also counts its two int8 GEMMs, K3 its four and its f32 core) with the share
of it the call reaches.  Prints one line a shape, the per-step sums, and the
card's name and power limit.  `--plans` also times, at every shape, each K2
plan `ops.fused_gn.k2_plans` offers, K6 at 128, 256 and 512 threads a block,
and each K4 plan `ops.fused_gn.k4_plans` offers (the plan `epilogue_plan`
picks is marked `*`), each checked against the plain version; K7 under
each plan `ops.fused_gn.k7_plans` offers, each checked to the bit.  At
each K4 shape that takes the blocked form, `K4.blocked` lines check it to
the bit on the f32 stream and bf16 with 1 and 3 outputs and time it beside
its bytes bound and beside the cluster form's plan.

K7 rows: `K7` on the serving path's inputs at an identity-shortcut exit
(bf16 conv2 output, bf16 residual, bf16 out), `K7.f32_res` on the same
values with the residual handed over as an f32 copy (what the serving path
once passed), and `copy`, that copy alone (`h_res.to(torch.float32)`).
"""
import argparse
import collections
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from attentiondm_tpu_torch.config import load_config  # noqa: E402
from attentiondm_tpu_torch.models.unet import UNetConfig  # noqa: E402
from attentiondm_tpu_torch.ops import checks, fused_gn  # noqa: E402

BATCH = {"cifar10": 128, "church": 32, "celeba-wide": 64, "imagenet64": 32}


def configs():
    celeba = dataclasses.replace(UNetConfig.from_config(load_config("celeba.yml")), attn_resolutions=(64, 32, 16))
    return {"cifar10": UNetConfig(), "church": UNetConfig.from_config(load_config("church.yml")), "celeba-wide": celeba,
            "imagenet64": UNetConfig.from_config(load_config("imagenet64.yml"))}


def epilogue_args(B, HW, N, gen, dev):
    """bf16 conv1 output (identity dequant), one channel group at mean 40, as chip_smoke's check."""
    H = int(HW ** 0.5)

    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    zcbias = torch.zeros(N, device=dev)
    zcbias[:N // 32] = 40.0
    return (randf((B, H, H, N), 2.0, 0.3).to(torch.bfloat16), torch.ones(N, device=dev), zcbias, randf((B, N)),
            randf((N,), 0.1, 1.0), randf((N,), 0.1), torch.full((N,), 255 / 4.5, device=dev),
            torch.full((N,), round(255 / 4.5 * -0.5) + 128.0, device=dev), 8)


def sweep(kind, B, HW, N, a, chosen):
    """Device time of the call under each plan of the shape (see --plans)."""
    if kind == "K2":
        plans = fused_gn.k2_plans(HW, N, 2)
        fn = fused_gn.epilogue_gn_swish_quant_whole
    else:
        V = N // fused_gn.VEC
        plans = [{**chosen, "threads": min(fused_gn.WIN, t // V) * V,
                  "smem": 4 * 2 * N * (min(fused_gn.WIN, t // V) + 1)} for t in (128, 256, 512)]
        fn = fused_gn.epilogue_gn_swish_quant_blocked
    want = fn(*a, plain=True)
    plan_of = fused_gn.epilogue_plan
    try:
        for plan in plans:
            fused_gn.epilogue_plan = lambda *_, plan=plan: plan
            equal = torch.equal(fn(*a), want)
            ms = chip_smoke.device_ms(lambda: fn(*a))
            print(f"  {'*' if plan == chosen else ' '} {kind} B={B} HW={HW} N={N} "
                  + " ".join(f"{k}={v}" for k, v in plan.items() if k != "kind")
                  + f": device {ms * 1e3:.1f} us, equal: {equal}")
    finally:
        fused_gn.epilogue_plan = plan_of


def entry_args(B, HW, C, gen, dev, n_out=1, dtype=torch.bfloat16):
    """A residual of `dtype` (one channel group at offset 40) and n_out 8-bit quantizations (output i at a range
    shifted by i / 2), as chip_smoke's K4 check."""
    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    x = randf((B, HW, C), 2.0, 0.3)
    x[..., :C // 32] += 40.0
    sc = 255 / 4.5
    qp = [(torch.full((C,), sc, device=dev), torch.full((C,), round(sc * (-0.5 - i / 2)) + 128.0, device=dev), 8)
          for i in range(n_out)]
    return (x.to(dtype), randf((C,), 0.1, 1.0), randf((C,), 0.1), qp)


def resblock_args(B, H, C, gen, dev):
    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    def quant(lo, hi):
        sc = 255 / (hi - lo)
        return torch.full((C,), sc, device=dev), torch.full((C,), round(sc * lo) + 128.0, device=dev)

    def fold():
        g = torch.randint(-8, 8, (9 * C, C), generator=gen, dtype=torch.int8).to(dev)
        return g, (randf((C,), 2e-5, 2e-4).abs(), randf((C,), 0.1))

    (g1, sb1), (g2, sb2) = fold(), fold()
    args = (randf((B, H, H, C), 1.5, 0.2).to(torch.bfloat16), randf((B, C)), randf((C,), 0.1, 1.0),
            randf((C,), 0.1), quant(-0.5, 4.0), g1, sb1, randf((C,), 0.1, 1.0), randf((C,), 0.1),
            quant(-0.5, 3.0), g2, sb2)
    return args, dict(g1_t=g1.t().contiguous(), g2_t=g2.t().contiguous())


def attention_args(B, L, C, gen, dev):
    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    def weights(lo, hi):
        g = torch.randint(-8, 8, (C, C), generator=gen, dtype=torch.int8).to(dev)
        return g, randf((C,), lo, hi).abs(), randf((C,), 0.1), g.t().contiguous()

    qkv_quant = [(torch.full((C,), 255 / 8.0, device=dev), torch.zeros(C, device=dev), b) for b in (8, 6, 8)]
    o_quant = (torch.full((C,), 255 / 4.0, device=dev), torch.zeros(C, device=dev), 8)
    return (randf((B, L, C)).to(torch.bfloat16), randf((C,), 0.1, 1.0), randf((C,), 0.1), qkv_quant,
            [weights(1e-5, 2e-4) for _ in range(3)], o_quant, weights(1e-5, 1e-3))


def plan_of(B, HW, N, dtype, kind, n_out=1):
    """The tree's launch plan, where it has one for the kind (None on a tree without)."""
    try:
        return fused_gn.epilogue_plan(B, HW, N, dtype, kind, *([n_out] if n_out != 1 else []))
    except (AttributeError, TypeError, ValueError, NotImplementedError):
        return None


def sweep_k4(B, HW, C, a, chosen):
    """Device time of K4 under each plan `k4_plans` offers at the shape."""
    want = fused_gn.gn_act_quant(*a, plain=True)
    plan_of_ = fused_gn.epilogue_plan
    try:
        for plan in fused_gn.k4_plans(B, HW, C, 2, 1):
            fused_gn.epilogue_plan = lambda *_, plan=plan: plan
            equal = all(torch.equal(g, w) for g, w in zip(fused_gn.gn_act_quant(*a), want))
            ms = chip_smoke.device_ms(lambda: fused_gn.gn_act_quant(*a))
            print(f"  {'*' if plan == chosen else ' '} K4 B={B} HW={HW} C={C} "
                  + " ".join(f"{k}={v}" for k, v in plan.items() if k != "kind")
                  + f": device {ms * 1e3:.1f} us, equal: {equal}")
    finally:
        fused_gn.epilogue_plan = plan_of_


def blocked_rows(B, HW, C, gen, dev, n, rows, plans=False):
    """K4's blocked form at a shape past 32 windows, on the f32 stream and bf16, with 1 and 3 outputs (3 with
    act="none", as the composed attention entry): bit-equal to the plain version, its device time beside the
    bytes bound (x read once, n_out B written) and beside the cluster form's plan at the same shape; with
    `plans`, also every other plan `blocked_plans` offers, each checked to the bit."""
    plan_of_ = fused_gn.epilogue_plan
    for dtype in (torch.float32, torch.bfloat16):
        for n_out in (1, 3):
            a = entry_args(B, HW, C, gen, dev, n_out, dtype)
            act = "swish" if n_out == 1 else "none"
            blocked = plan_of_(B, HW, C, dtype, "K4", n_out)
            cluster = min(fused_gn.k2_plans(HW, C, a[0].element_size(), fused_gn.max_threads(n_out), kind="K4"),
                          key=lambda p: fused_gn._cluster_rank(p, B, C, a[0].element_size()))
            want = fused_gn.gn_act_quant(*a, act=act, plain=True)
            times = {}
            others = [(f"threads={p['threads']}", p) for p in fused_gn.blocked_plans(HW, C, n_out) if p != blocked]
            try:
                for form, plan in [("blocked", blocked), ("cluster", cluster)] + (others if plans else []):
                    fused_gn.epilogue_plan = lambda *_, plan=plan: plan
                    equal = all(torch.equal(g, w) for g, w in zip(fused_gn.gn_act_quant(*a, act=act), want))
                    if not equal:
                        raise SystemExit(f"gn_shapes: K4's {form} plan {plan} at B={B} HW={HW} C={C} {dtype} "
                                         f"{n_out} outputs differs from its plain version")
                    times[form] = chip_smoke.device_ms(lambda: fused_gn.gn_act_quant(*a, act=act))
            finally:
                fused_gn.epilogue_plan = plan_of_
            b = max(chip_smoke.bound(chip_smoke.nbytes(a[0]) + n_out * a[0].numel()))
            rows.append(dict(kind="K4.blocked", B=B, shape=f"HW={HW} C={C}", dtype=str(dtype), n_out=n_out,
                             per_step=n, device_ms=times["blocked"], cluster_ms=times["cluster"], bound_ms=b,
                             share=b / times["blocked"], plan=blocked, cluster_plan=cluster))
            print(f"  K4.blocked B={B} HW={HW} C={C} {str(dtype)[6:]} {n_out} out x{n}/step: bit-equal; device "
                  f"{times['blocked']:.4f} ms, bound {b:.4f} ms ({b / times['blocked']:.1%}), cluster form "
                  f"{times['cluster']:.4f} ms ({times['cluster'] / times['blocked']:.2f}x); plan {blocked}"
                  + "".join(f"; {k} {v:.4f} ms" for k, v in times.items() if k not in ("blocked", "cluster")))
            del a, want


def exit_args(B, HW, N, gen, dev):
    """K7's inputs at an identity-shortcut exit, as chip_smoke's check: bf16 conv2 output with the identity
    dequant and the bf16 residual stream, one channel group at offset 40."""
    def randf(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    x = randf((B, HW, N), 2.0, 0.5)
    x[..., :N // 32] += 40.0
    return (randf((B, HW, N), 1.5, 0.2).to(torch.bfloat16), torch.ones(N, device=dev), torch.zeros(N, device=dev),
            x.to(torch.bfloat16))


def sweep_k7(B, HW, N, a, want, chosen):
    """Device time of K7 under each plan `k7_plans` offers at the shape."""
    fn = fused_gn.epilogue_residual_gn_stats
    plan_of_ = fused_gn.epilogue_plan
    try:
        for plan in fused_gn.k7_plans(HW, N):
            fused_gn.epilogue_plan = lambda *_, plan=plan: plan
            equal = all(torch.equal(g, w) for g, w in zip(fn(*a, out_dtype=torch.bfloat16), want))
            ms = chip_smoke.device_ms(lambda: fn(*a, out_dtype=torch.bfloat16))
            print(f"  {'*' if plan == chosen else ' '} K7 B={B} HW={HW} N={N} "
                  + " ".join(f"{k}={v}" for k, v in plan.items() if k != "kind")
                  + f": device {ms * 1e3:.1f} us, equal: {equal}")
    finally:
        fused_gn.epilogue_plan = plan_of_


def lever_rows(path, cfg, B, gen, dev, args, rows, only):
    """K4, K7, K12 and K3 at every shape of a serving step with the three levers."""
    from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
    from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas

    plan = checks.lever_plan(cfg, B, entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
    totals = collections.defaultdict(lambda: [0.0, 0.0])

    def row(kind, shape, n, ms, b, equal, plan):
        totals[kind][0] += n * ms
        totals[kind][1] += n * b
        rows.append(dict(path=path, kind=kind, B=B, shape=shape, per_step=n, device_ms=ms, bound_ms=b, share=b / ms,
                         equal=equal, plan=plan))
        print(f"{path} {kind} B={B} {shape} x{n}/step: device {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%}), equal to "
              f"the plain version: {equal}" + (f"; plan {plan}" if plan else ""))

    if "K4" in only:
        for (HW, C), n in sorted(collections.Counter((HW, C) for _s, HW, C in plan["K4"]).items()):
            a = entry_args(B, HW, C, gen, dev)
            got = fused_gn.gn_act_quant(*a)
            equal = all(torch.equal(g, w) for g, w in zip(got, fused_gn.gn_act_quant(*a, plain=True)))
            ms = chip_smoke.device_ms(lambda: fused_gn.gn_act_quant(*a))
            b = max(chip_smoke.bound(chip_smoke.nbytes(a[0]) + a[0].numel() + 4 * 4 * C,
                                     f32_flops=16 * a[0].numel()))
            chosen = plan_of(B, HW, C, torch.bfloat16, "K4")
            row("K4", f"HW={HW} C={C}", n, ms, b, equal, chosen)
            if args.plans and hasattr(fused_gn, "k4_plans"):
                sweep_k4(B, HW, C, a, chosen)
            del a, got
            if chosen and chosen.get("form") == "blocked":
                blocked_rows(B, HW, C, gen, dev, n, rows, args.plans)
    if "K7" in only:
        k7 = fused_gn.epilogue_residual_gn_stats
        for (HW, N), n in sorted(collections.Counter((HW, N) for _s, HW, N in plan["K7"]).items()):
            a = exit_args(B, HW, N, gen, dev)
            want = k7(*a, out_dtype=torch.bfloat16, plain=True)
            for kind, x_res in (("K7", a[3]), ("K7.f32_res", a[3].to(torch.float32))):
                ak = (*a[:3], x_res)
                got = k7(*ak, out_dtype=torch.bfloat16)
                equal = all(torch.equal(g, w) for g, w in zip(got, want))
                ms = chip_smoke.device_ms(lambda: k7(*ak, out_dtype=torch.bfloat16))
                b = max(chip_smoke.bound(chip_smoke.nbytes(*ak, *got), f32_flops=8 * a[0].numel()))
                row(kind, f"HW={HW} N={N}", n, ms, b, equal,
                    plan_of(B, HW, N, torch.bfloat16, "K7") if kind == "K7" else None)
                del ak, got
            ms = chip_smoke.device_ms(lambda: a[3].to(torch.float32))
            b = max(chip_smoke.bound(3 * chip_smoke.nbytes(a[3])))  # 2 B read, 4 B written an element
            row("copy", f"HW={HW} N={N} h_res.to(float32)", n, ms, b, True, None)
            if args.plans and hasattr(fused_gn, "k7_plans"):
                sweep_k7(B, HW, N, a, want, plan_of(B, HW, N, torch.bfloat16, "K7"))
            del a, want
    if "K12" in only:
        for (H, C), n in sorted(collections.Counter((H, C) for _s, H, C in plan["K12"]).items()):
            a, kt = resblock_args(B, H, C, gen, dev)
            equal = torch.equal(resblock_pallas(*a, **kt), resblock_pallas(*a, plain=True))
            ms = chip_smoke.device_ms(lambda: resblock_pallas(*a, **kt))
            r = a[0]
            b = max(chip_smoke.bound(2 * chip_smoke.nbytes(r) + chip_smoke.nbytes(a[5], a[10]) + 4 * B * C + 48 * C,
                                     int8_ops=2 * 2 * r.numel() * 9 * C, f32_flops=(16 + 18 + 3) * r.numel()))
            plans = [plan_of(B, H * H, C, dt, "K4") for dt in (torch.bfloat16, torch.int32)]
            row("K12", f"H={H} C={C}", n, ms, b, equal, plans if plans[0] else None)
            del a, kt
    if "K3" in only:
        _k1, _k2, _k6, k3, _c = checks.conv_plan(cfg)
        for (L, C), n in sorted(collections.Counter(k3).items()):
            a = attention_args(B, L, C, gen, dev)
            for core in (False, True):
                fn = lambda: fused_attention_block(*a, scale=C ** -0.5, int8_core=core)  # noqa: E731
                got = fn()
                want = fused_attention_block(*a, scale=C ** -0.5, int8_core=core, plain=True)
                ok = checks.compare("K3", got, want)["ok"]
                ms = chip_smoke.device_ms(fn)
                b = max(chip_smoke.bound(2 * chip_smoke.nbytes(a[0]) + 4 * C * C + 16 * 4 * C,
                                         int8_ops=4 * 2 * B * L * C * C + (2 * B * L * L * C if core else 0),
                                         tf32x3_flops=(1 if core else 2) * 2 * B * L * L * C,
                                         f32_flops=30 * a[0].numel() + 5 * B * L * L))
                row("K3.int8_core" if core else "K3", f"L={L} C={C}", n, ms, b, f"within tolerance: {ok}",
                    plan_of(B, L, C, torch.bfloat16, "K4", 3))
            del a
    return totals


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--paths", default=",".join(BATCH), help="the configurations to measure (comma-separated)")
    ap.add_argument("--plans", action="store_true", help="also time every launch plan at each shape")
    ap.add_argument("--only", default="K2,K6,K4,K7,K12,K3", help="the kernels to time (comma-separated)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("gn_shapes: no CUDA device")
    card = chip_smoke.nvidia_smi_line()
    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(0)
    rows = []
    for path, cfg in configs().items():
        if path not in args.paths.split(","):
            continue
        B = BATCH[path]
        _k1, k2, k6, _k3, _c = checks.conv_plan(cfg)
        totals = collections.defaultdict(lambda: [0.0, 0.0])
        for kind, shapes in (("K2", k2), ("K6", k6)):
            if kind not in only:
                continue
            for (HW, N), n in sorted(collections.Counter(shapes).items()):
                a = epilogue_args(B, HW, N, gen, dev)
                got = fused_gn.epilogue_gn_swish_quant(*a)
                equal = torch.equal(got, fused_gn.epilogue_gn_swish_quant(*a, plain=True))
                ms = chip_smoke.device_ms(lambda: fused_gn.epilogue_gn_swish_quant(*a))
                b = max(chip_smoke.bound(chip_smoke.nbytes(*a[:8]) + got.numel(), f32_flops=18 * got.numel()))
                plan = plan_of(B, HW, N, torch.bfloat16, kind)
                totals[kind][0] += n * ms
                totals[kind][1] += n * b
                rows.append(dict(path=path, kind=kind, B=B, HW=HW, N=N, per_step=n, device_ms=ms, bound_ms=b,
                                 share=b / ms, equal=equal, plan=plan))
                print(f"{path} {kind} B={B} HW={HW} N={N} x{n}/step: device {ms:.4f} ms, bound {b:.4f} ms "
                      f"({b / ms:.1%}), equal to the plain version: {equal}"
                      + (f"; plan {plan}" if plan else ""))
                if args.plans:
                    sweep(kind, B, HW, N, a, plan)
                del a, got
        if path != "celeba-wide":
            totals.update(lever_rows(path, cfg, B, gen, dev, args, rows, only))
        for kind, (ms, b) in totals.items():
            print(f"== {path}: {kind} device time per serving step {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%})")
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
