"""The serving kernels against their plain versions: tolerances, the
per-site check of a serving step, and the launch plan of a config.

Used by `chip_smoke.py` and `tests/test_torch_gpu.py` on the card.

Tolerances, per kernel output against the plain version on the same inputs:
  K1 (K13, K5)  int32 out: equal; bf16 out: within 1 bf16 ulp everywhere
                (one rounding of the same f32 epilogue);
  K2, K6, K4    int8 codes: at most 1 LSB apart, on at most 0.1% of them;
  K3            mean relative error < 1e-3 and at least 99% of the
                elements within 1 bf16 ulp (f32 sums in another order);
  K7            residual' within 1 bf16 ulp everywhere and the sums within
                1e-6 relative (of the largest sum of their kind);
  K12           mean relative error < 1e-3 and at least 99.9% of the
                elements within 1 bf16 ulp;
  K8, K9        int8 codes: at most 1 LSB apart, on at most 0.2% of them
                (the softmax denominator and p.v sum in another order, and a
                p on a bf16 rounding tie moves the output's last bits);
  K10           the same on at most 1% (the online softmax rescales per key
                block);
  K3.core       K3's core alone (int8 codes of proj_out's input): at most
                1 LSB on at most 0.2% of them, as K8 / K9 (f32 sums in
                another order);
  K11           float32: every element within 2e-5 + 2e-5 |want| (f32 dot
                products in another order).
K4, K7 and K12 sum in the plain versions' order, so 0 LSB, equal sums and
equal outputs are what a run should print; the tolerances say what would
still be a pass.
"""
from __future__ import annotations

import contextlib

import torch

from . import fused_gn
from .attention import takes_flash


# int8 outputs: the share of codes that may differ (by at most 1 LSB) from the plain version's
CODE_SHARE = {"K2": 1e-3, "K6": 1e-3, "K8": 2e-3, "K9": 2e-3, "K10": 1e-2, "K3.core": 2e-3}


def _ulp_share(gf, wf):
    return ((gf - wf).abs() <= wf.abs() * 2.0 ** -7 + 1e-30).float().mean().item()


def compare(kind: str, got, want) -> dict:
    """Agreement figures of a kernel output with its plain version, and
    whether they meet the kernel's tolerance (`ok`).  K4's outputs come as a
    tuple of int8 tensors (the worst one counts), K7's as (residual', sums)."""
    if kind == "K4":
        figs = [compare("K2", g, w) for g, w in zip(got, want)]
        return max(figs, key=lambda f: (not f["ok"], f["max_abs_err"], f["frac"]))
    if kind == "K7":
        (go, gs), (wo, ws) = got, want
        err = (go.float() - wo.float()).abs().max().item()
        within = _ulp_share(go.float(), wo.float())
        sums_rel = ((gs - ws).abs().amax(dim=(0, 2)) / ws.abs().amax(dim=(0, 2))).max().item()
        return dict(max_abs_err=err, within=within, sums_rel=sums_rel, ok=within == 1.0 and sums_rel <= 1e-6)
    if kind == "K1" and got.dtype == torch.int32:
        err = (got - want).abs().max().item()
        return dict(max_abs_err=err, ok=err == 0)
    gf, wf = got.float(), want.float()
    d = (gf - wf).abs()
    err = d.max().item()
    if kind in CODE_SHARE:
        frac = (d > 0).float().mean().item()
        return dict(max_abs_err=err, frac=frac, ok=err <= 1 and frac <= CODE_SHARE[kind])
    if kind == "K11":
        return dict(max_abs_err=err, rel=(d.mean() / wf.abs().mean()).item(),
                    ok=bool((d <= 2e-5 + 2e-5 * wf.abs()).all()))
    within = _ulp_share(gf, wf)
    if kind == "K1":
        return dict(max_abs_err=err, within=within, ok=within == 1.0)
    rel = (d.mean() / wf.abs().mean()).item()
    return dict(max_abs_err=err, rel=rel, within=within,
                ok=rel < 1e-3 and within >= (0.999 if kind == "K12" else 0.99))


@contextlib.contextmanager
def per_site(records: list):
    """Teacher-forced per-site check of the serving forward: while active,
    every kernel call of `quant/int8_serving.py` also runs its plain version
    on the same inputs and appends (kernel, output shape, figures) to
    `records`; the forward goes on with the kernel's output.  The plain
    calls launch nothing, so launch counts stay the kernels' own."""
    from ..quant import int8_serving as srv

    from . import int8_attention as ia

    kinds = {
        "_k1": lambda *a: "K1",
        "epilogue_gn_swish_quant": lambda dot, *a: fused_gn.epilogue_route(dot.shape, dot.dtype),
        "fused_attention_block": lambda *a: "K3",
        "gn_act_quant": lambda *a: "K4",
        "epilogue_residual_gn_stats": lambda *a: "K7",
        "_rb_kernel": lambda *a: "K12",
        "fused_int8_attention": lambda *a: "K8",
        "fused_int8_attention_static":
            lambda q, *a: "K10" if ia.static_core_takes_flash(q.shape[1], q.shape[2]) else "K9",
        # the dense float32 softmax of a short map is no kernel and has no second version
        "spatial_attention": lambda q, *a: "K11" if takes_flash(q.shape[1], q.shape[2]) else None,
    }
    saved = {name: getattr(srv, name) for name in kinds}

    def wrap(fn, kind_of):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            kind = kind_of(*args)
            if kind is not None:
                want = fn(*args, **{**kwargs, "plain": True})
                shape = tuple((out if torch.is_tensor(out) else out[0]).shape)
                records.append((kind, shape, compare(kind, out, want)))
            return out

        return call

    for name, kind_of in kinds.items():
        setattr(srv, name, wrap(saved[name], kind_of))
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(srv, name, fn)


def conv_plan(cfg):
    """One serving step's kernel calls, derived from `iter_conv_layers` and
    the config: K1 launches (name, H_in, Cp, Np, ksize, stride, out dtype),
    the K2 and K6 epilogue shapes (HW, N), routed by `epilogue_route` on the
    bf16 conv1 output, the K3 shapes (L, C) of the attention sites that
    `fused_attention_block_fits` lets in, and the other, composed sites
    (name, L, C), whose four 1x1 projections are K1 launches."""
    from ..models.unet import iter_conv_layers
    from ..quant.int8_runtime import _eligible
    from .int8_attention import fused_attention_block_fits

    def rup(c):
        return (c + 127) // 128 * 128

    levels = len(cfg.ch_mult)
    res = [cfg.resolution >> i for i in range(levels)]
    k1, epi, k3, composed = [], {"K2": [], "K6": []}, [], []
    for name, cin, k in iter_conv_layers(cfg):
        parts = name.split(".")
        if not _eligible((k, k, cin, 0)):
            continue
        if parts[0] == "mid":
            lvl = levels - 1
        elif parts[0] == "conv_out":
            lvl = 0
        else:
            lvl = int(parts[1])
        H, cout = res[lvl], cfg.ch * cfg.ch_mult[lvl]
        if ".attn" in name or parts[0] == "mid" and parts[1] == "attn_1":
            if fused_attention_block_fits(H * H, cin):
                if parts[-1] == "q":
                    k3.append((H * H, cin))
                continue
            if parts[-1] == "q":
                composed.append((name.rsplit(".", 1)[0], H * H, cin))
            k1.append((name, H, rup(cin), rup(cin), 1, 1, torch.int32))
            continue
        stride, mode = 1, torch.int32
        if parts[-1] in ("conv1", "conv2"):
            cout = cin if parts[0] == "mid" else cout
            mode = torch.bfloat16
            if parts[-1] == "conv1":
                epi[fused_gn.epilogue_route((1, H, H, cout), torch.bfloat16)].append((H * H, cout))
        elif parts[0] == "conv_out":
            cout = cfg.out_ch
        elif parts[-2] == "downsample":
            cout, stride = cin, 2
        elif parts[-2] == "upsample":
            cout, H = cin, 2 * H
        k1.append((name, H, rup(cin), rup(cout), k, stride, mode))
    return k1, epi["K2"], epi["K6"], k3, composed


def attention_sites(cfg) -> list:
    """(site, L, C) of every attention block of a serving step that the int8
    path covers (q projection eligible), in forward order."""
    from ..models.unet import iter_conv_layers
    from ..quant.int8_runtime import _eligible

    levels = len(cfg.ch_mult)
    sites = []
    for name, cin, k in iter_conv_layers(cfg):
        parts = name.split(".")
        if parts[-1] != "q" or not _eligible((k, k, cin, 0)):
            continue
        H = cfg.resolution >> (levels - 1 if parts[0] == "mid" else int(parts[1]))
        sites.append((name.rsplit(".", 1)[0], H * H, cin))
    return sites


def attention_plan(cfg, *, attn_int8=True, attn_ranges=None) -> dict:
    """The attention cores of one serving step under the attention flags, by
    the dispatchers' own predicates: {"K3.int8_core": [(L, C)], "K8": [...],
    "K9": [...], "K10": [...], "K11": [...], "refused": [(site, L, C,
    kernel)]}.  `attn_ranges`: the calibrated ranges' dict (or any container
    of projection names), or True for every site.  "refused" names the sites
    whose CUDA kernel would refuse the map (K3 off `k3_takes`, K8 / K9 / K10
    off `int8_core_takes`): on the card `serving_ddim_sampler` raises with
    them before its first step (`require_attention_kernels`).  The int8 core
    of a composed site needs its projections unpadded (C % 128 == 0);
    otherwise the site takes the f32 branch, as `_attn_fused` does."""
    from . import int8_attention as ia

    plan = {k: [] for k in ("K3.int8_core", "K8", "K9", "K10", "K11", "refused")}
    for site, L, C in attention_sites(cfg):
        if ia.fused_attention_block_fits(L, C):
            if attn_int8:
                plan["K3.int8_core"].append((L, C))
            if not ia.k3_takes(L, C):
                plan["refused"].append((site, L, C, "K3"))
            continue
        if not attn_int8 or C % 128:
            if takes_flash(L, C):
                plan["K11"].append((L, C))
            continue
        static = attn_ranges is True or (
            attn_ranges is not None and all(f"{site}.{k}" in attn_ranges for k in ("q", "k", "v")))
        kind = ("K10" if ia.static_core_takes_flash(L, C) else "K9") if static else "K8"
        plan[kind].append((L, C))
        if not ia.int8_core_takes(L, C):
            plan["refused"].append((site, L, C, kind))
    return plan


def require_attention_kernels(cfg, device, *, attn_int8=True, attn_ranges=None):
    """Raise NotImplementedError, naming every site, where a serving step on
    `device` would reach an attention kernel that refuses its map; CPU
    tensors take the plain versions, which take any map."""
    if torch.device(device).type != "cuda":
        return
    refused = attention_plan(cfg, attn_int8=attn_int8, attn_ranges=attn_ranges)["refused"]
    if refused:
        raise NotImplementedError(
            "attention sites off the CUDA kernels' shapes (K3: C in (128, 256, 512), L <= 1024; K8 / K9 / K10: "
            "C in (128, 256, 512), L % 64 == 0): "
            + ", ".join(f"{site} (L={L}, C={C}) -> {kind}" for site, L, C, kind in refused))


def lever_plan(cfg, batch: int, *, entry_pallas=False, boundary_fusion=False, resblock_pallas=False) -> dict:
    """The sites of one serving step that the three levers send through K4,
    K7 and K12, from the config and the forward's own predicates (no
    tensors): {"K4": [(site, HW, C)], "K7": [(site, HW, N)], "K12": [(site,
    H, C)]}.  A site is a resblock's name, or "conv_out" for its entry."""
    from ..models.unet import iter_conv_layers
    from .pallas_conv import conv3_pallas_wins
    from .pallas_resblock import resblock_pallas_fits

    cin_of = {name: cin for name, cin, _k in iter_conv_layers(cfg)}
    levels, nrb = len(cfg.ch_mult), cfg.num_res_blocks
    res = [cfg.resolution >> i for i in range(levels)]
    attn = [r in cfg.attn_resolutions for r in res]
    plan = {"K4": [], "K7": [], "K12": []}
    sums = False  # whether a K7 exit's sums reach the next block's norm1

    def block(name, lvl, want=False):
        nonlocal sums
        H, cin = res[lvl], cin_of[f"{name}.conv1"]
        cout = cin if name.startswith("mid") else cfg.ch * cfg.ch_mult[lvl]
        entry_sums, sums = sums, False
        if (resblock_pallas and not entry_sums and not want and cin == cout and cin % 128 == 0
                and resblock_pallas_fits(batch, H, H, cin)
                and (resblock_pallas == "all" or conv3_pallas_wins(batch, H, H, cin, cin))):
            plan["K12"].append((name, H, cin))
            return
        if entry_pallas and not entry_sums and fused_gn.gn_act_quant_fits(H * H, cin):
            plan["K4"].append((name, H * H, cin))
        if want and cout % 128 == 0 and fused_gn.epilogue_residual_gn_stats_fits(H * H, cout):
            plan["K7"].append((name, H * H, cout))
            sums = True

    for lvl in range(levels):
        for j in range(nrb):
            block(f"down.{lvl}.block.{j}", lvl,
                  want=bool(boundary_fusion) and not attn[lvl] and (j != nrb - 1 or lvl == levels - 1))
            if attn[lvl]:
                sums = False
        if lvl != levels - 1:
            sums = False
    block("mid.block_1", levels - 1)
    sums = False  # mid.attn_1
    block("mid.block_2", levels - 1)
    for lvl in reversed(range(levels)):
        for j in range(nrb + 1):
            block(f"up.{lvl}.block.{j}", lvl)
    if entry_pallas and fused_gn.gn_act_quant_fits(res[0] * res[0], cin_of["conv_out"]):
        plan["K4"].append(("conv_out", res[0] * res[0], cin_of["conv_out"]))
    return plan


def expected_launches(cfg, steps: int = 1, batch: int = 1, *, attn_int8=True, attn_ranges=None,
                      **levers) -> dict:
    """Launch counts of `steps` serving steps, per kernel (K13 and K5 are
    K1's int32 3x3 and 1x1 launches, "K3.int8_core" the K3 launches that ran
    the int8 core), under the attention flags
    (`attention_plan`'s keywords, the serving defaults) and the levers given
    (`lever_plan`'s keywords; none: the levers-off path).  A block K12 takes
    launches neither its two K1 convs nor its K2 / K6 epilogue; a composed
    attention site launches K1 four times."""
    k1, k2, k6, k3, _composed = conv_plan(cfg)
    attn = attention_plan(cfg, attn_int8=attn_int8, attn_ranges=attn_ranges)
    plan = lever_plan(cfg, batch, **levers)
    whole = {site for site, _H, _C in plan["K12"]}
    k1 = [c for c in k1 if c[0].rsplit(".", 1)[0] not in whole]
    taken = [(H * H, C) for _site, H, C in plan["K12"]]
    for shapes in (k2, k6):
        for shape in list(taken):
            if shape in shapes:
                shapes.remove(shape)
                taken.remove(shape)
    counts = {"K1": len(k1), "K2": len(k2), "K6": len(k6), "K3": len(k3),
              "K5": sum(1 for c in k1 if c[4] == 1),
              "K13": sum(1 for c in k1 if c[4] == 3 and c[5] == 1 and c[6] == torch.int32),
              "K4": len(plan["K4"]), "K7": len(plan["K7"]), "K12": len(plan["K12"]),
              **{k: len(v) for k, v in attn.items() if k != "refused"}}
    return {k: n * steps for k, n in counts.items()}


def launch_counters() -> dict:
    """The kernel wrappers whose `.launches` count their kernels."""
    from .fused_gn import (
        epilogue_gn_swish_quant_blocked,
        epilogue_gn_swish_quant_whole,
        epilogue_residual_gn_stats,
        gn_act_quant,
    )
    from .attention import flash_attention
    from .int8_attention import (
        fused_attention_block,
        fused_int8_attention,
        fused_int8_attention_static,
        int8_flash_attention_static,
    )
    from .pallas_conv import int8_conv
    from .pallas_resblock import resblock_pallas

    return {"K1": int8_conv, "K2": epilogue_gn_swish_quant_whole, "K6": epilogue_gn_swish_quant_blocked,
            "K3": fused_attention_block, "K4": gn_act_quant, "K7": epilogue_residual_gn_stats,
            "K12": resblock_pallas, "K8": fused_int8_attention, "K9": fused_int8_attention_static,
            "K10": int8_flash_attention_static, "K11": flash_attention}


def reset_launches():
    counters = launch_counters()
    counters["K1"].launches_by_mode = {}
    for fn in counters.values():
        fn.launches = 0
    counters["K3"].int8_core_launches = 0


def read_launches() -> dict:
    counters = launch_counters()
    by_mode = counters["K1"].launches_by_mode
    return {**{k: fn.launches for k, fn in counters.items()},
            "K5": by_mode.get("1x1/s1/int32", 0), "K13": by_mode.get("3x3/s1/int32", 0),
            "K3.int8_core": counters["K3"].int8_core_launches}
