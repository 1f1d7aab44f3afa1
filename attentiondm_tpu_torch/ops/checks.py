"""The serving kernels against their plain versions: tolerances, the
per-site check of a serving step, and the launch plan of a config.

Used by `chip_smoke.py` and `tests/test_torch_gpu.py` on the card.

Tolerances, per kernel output against the plain version on the same inputs:
  K1 (K13, K5)  int32 out: equal; bf16 out: within 1 bf16 ulp everywhere
                (one rounding of the same f32 epilogue);
  K2, K6, K4    int8 codes: at most 1 LSB apart, on at most 0.1% of them;
  K3            mean relative error < 1e-3 and at least 99% of the
                elements within 1 bf16 ulp (f32 sums in another order);
                at a float32 residual the output is not rounded, so
                instead at least K3_F32_WITHIN of the elements within 2
                f32 ulp (a proj_out input code that the core's sums move
                across a tie moves its whole row);
  K7            residual' within 1 bf16 ulp everywhere and the sums within
                1e-6 relative (of the largest sum of their kind);
  K12           mean relative error < 1e-3 and at least 99.9% of the
                elements within 1 bf16 ulp (bf16 or float32 residual);
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
from .attention import flash_takes, takes_flash


# the card's published peaks (H100 SXM data sheet, dense), for the bounds of chip_smoke.py and the probes
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12  # tensor cores, dense
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
# f32 products on the tensor cores as 3xTF32 (K3's core): three TF32 products (495 TFLOP/s dense) for each.
# One TF32 pass would be faster but rounds each operand to 10 bits, which K3's tolerance does not allow
# (1.3% of proj_out's input codes flip), so the split is the least work that computes the function.
TF32X3_FLOPS_PER_S = 495e12 / 3


def bound_ms(nbytes, int8_ops=0, f32_flops=0, bf16_flops=0, tf32x3_flops=0):
    """(bytes ms, operations ms) the card needs at least for the work: the
    bytes over the memory rate, the operations over the peak of their type."""
    ops = (int8_ops / INT8_OPS_PER_S + bf16_flops / BF16_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S
           + tf32x3_flops / TF32X3_FLOPS_PER_S)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops * 1e3


# int8 outputs: the share of codes that may differ (by at most 1 LSB) from the plain version's
CODE_SHARE = {"K2": 1e-3, "K6": 1e-3, "K8": 2e-3, "K9": 2e-3, "K10": 1e-2, "K3.core": 2e-3}
# K3 at a float32 residual: the share of outputs within 2 f32 ulp of the plain version's.  Measured on the H100: at
# least 0.9484 (chip_smoke's (32, 64, 1024) check), 0.9861 at every site of a CIFAR-10 step; bounded at 2x the
# share off
K3_F32_WITHIN = 0.9


def _ulp_share(gf, wf):
    return ((gf - wf).abs() <= wf.abs() * 2.0 ** -7 + 1e-30).float().mean().item()


def _f32_ulp_share(got, want, ulps: int = 2):
    """The share of float32 outputs within `ulps` f32 ulp of the plain version's."""
    return ((got - want).abs() <= ulps * torch.finfo(torch.float32).eps * want.abs() + 1e-30).float().mean().item()


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
    if kind in ("K1", "K13", "K5") and got.dtype == torch.int32:
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
    if kind == "K3" and got.dtype == torch.float32:
        f32_within = _f32_ulp_share(gf, wf)
        return dict(max_abs_err=err, rel=rel, within=within, f32_within=f32_within,
                    ok=rel < 1e-3 and within >= 0.99 and f32_within >= K3_F32_WITHIN)
    return dict(max_abs_err=err, rel=rel, within=within,
                ok=rel < 1e-3 and within >= (0.999 if kind == "K12" else 0.99))


@contextlib.contextmanager
def per_site(records: list):
    """Teacher-forced per-site check of the serving forward and of the
    interception runtime: while active, every kernel call of
    `quant/int8_serving.py` and every int8 product of `ops/quant_conv.py`
    (K13, K5) also runs its plain version on the same inputs and appends
    (kernel, output shape, figures) to `records`; the forward goes on with
    the kernel's output.  The plain calls launch nothing, so launch counts
    stay the kernels' own."""
    from ..quant import int8_serving as srv

    from . import int8_attention as ia
    from . import quant_conv as qc

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
        # the dense float32 softmax of a short one-head map is no kernel and has no second version
        "head_attention": lambda q, k, v, heads, *a: "K11" if heads > 1 or takes_flash(q.shape[1], q.shape[2])
        else None,
    }
    # the interception runtime's products (quantized_conv2d_int8 / _prefolded): K1's int32 3x3 and 1x1 modes
    qc_kinds = {"conv3x3_int8_dot": lambda *a: "K13", "int8_matmul": lambda *a: "K5"}
    saved = {name: getattr(srv, name) for name in kinds}
    qc_saved = {name: getattr(qc, name) for name in qc_kinds}

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
    for name, kind_of in qc_kinds.items():
        setattr(qc, name, wrap(qc_saved[name], kind_of))
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(srv, name, fn)
        for name, fn in qc_saved.items():
            setattr(qc, name, fn)


def fused_block(cin: int, cout: int) -> bool:
    """Whether a resblock of `cin` -> `cout` channels takes the fused chain
    of `quant/int8_serving._resblock_fused`: both convs in the fold (at least
    64 input channels) and conv1's output unpadded (cout on the 128 grid),
    JAX's `fused`.  Any other block runs the unfused chain: plain GroupNorm,
    each conv through `_conv_any` (K1 in int32 mode where the fold covers it,
    the fake-quant float conv elsewhere)."""
    return cin >= 64 and cout >= 64 and cout % 128 == 0


def _k3_site(L: int, C: int) -> bool:
    """Whether an attention site takes K3 whole: JAX's `fits` (the budget,
    and folds of exactly (C, C), i.e. C on the 128 grid)."""
    from .int8_attention import fused_attention_block_fits

    return C % 128 == 0 and fused_attention_block_fits(L, C)


def conv_plan(cfg, widths=False, *, dot_bf16=True):
    """One serving step's kernel calls, derived from `iter_conv_layers` and
    the config: K1 launches (name, H_in, Cp, Np, ksize, stride, out dtype;
    with `widths`, then the (cin, cout) the conv needs before the padding to
    128 columns, which a bound on its work counts),
    the K2 and K6 epilogue shapes (HW, N), routed by `epilogue_route` on
    conv1's output (bf16, or with `dot_bf16=False` the int32 accumulator,
    which also runs both resblock convs in K1's int32 mode), the K3 shapes
    (L, C) of the attention sites that `fused_attention_block_fits` lets in,
    and the other, composed sites (name, L, C), whose four 1x1 projections
    are K1 launches.  An enhanced
    attention site is no K3 and no composed site: its four 1x1 projections
    (query and key to C / 8 channels, padded to 128 columns) are K1 launches
    in int32 mode, around a core in plain torch.  A resblock off
    `fused_block` launches each conv the fold covers in int32 mode and no
    epilogue kernel; a conv the fold does not cover launches nothing."""
    from ..models.unet import iter_conv_layers
    from ..quant.int8_runtime import _eligible

    def rup(c):
        return (c + 127) // 128 * 128

    levels = len(cfg.ch_mult)
    res = [cfg.resolution >> i for i in range(levels)]
    k1, epi, k3, composed = [], {"K2": [], "K6": []}, [], []
    cin_of = {name: cin for name, cin, _k in iter_conv_layers(cfg)}
    dot = torch.bfloat16 if dot_bf16 else torch.int32

    def launch(name, H, cin, cout, k, stride, mode):
        k1.append((name, H, rup(cin), rup(cout), k, stride, mode) + ((cin, cout) if widths else ()))

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
            if cfg.attn_variant == "enhanced":
                cout = cin // 8 if parts[-1] in ("query_conv", "key_conv") else cin
                launch(name, H, cin, cout, 1, 1, torch.int32)
                continue
            if _k3_site(H * H, cin):
                if parts[-1] == "q":
                    k3.append((H * H, cin))
                continue
            if parts[-1] == "q":
                composed.append((name.rsplit(".", 1)[0], H * H, cin))
            launch(name, H, cin, cin, 1, 1, torch.int32)
            continue
        stride, mode = 1, torch.int32
        if parts[-1] in ("conv1", "conv2"):
            cout = cin if parts[0] == "mid" else cout
            block = name.rsplit(".", 1)[0]
            if fused_block(cin_of[f"{block}.conv1"], cout):
                mode = dot
                if parts[-1] == "conv1":
                    epi[fused_gn.epilogue_route((1, H, H, cout), dot)].append((H * H, cout))
        elif parts[0] == "conv_out":
            cout = cfg.out_ch
        elif parts[-2] == "downsample":
            cout, stride = cin, 2
        elif parts[-2] == "upsample":
            cout, H = cin, 2 * H
        launch(name, H, cin, cout, k, stride, mode)
    return k1, epi["K2"], epi["K6"], k3, composed


def adm_step_plan(cfg, batch: int, *, dot_bf16=True, residual_dtype=torch.float32) -> dict:
    """One serving step of ADM's UNet (models/adm.py, `_serving_adm_apply`)
    as its kernel calls, from the block list and the forward's own
    predicates: {"K1": [(name, H_out, Cp, Np, ksize, mode)], "K2": [(site,
    HW, N)], "K6": [...], "K4": [(site, HW, C)], "K11": [(site, L, C,
    heads)], "K3": [(site, L, C)], "plain": [(site, what)]}.  A `fused_block` resblock
    launches K4 at its entry (at the low resolution in an upsampling block;
    a downsampling block's entry, whose pool sits before its quantizer,
    runs in plain torch), K1 for conv1 and conv2 in `dot_bf16`'s mode with
    K2 / K6 between them, and K1's int32 1x1 mode for a `nin_shortcut`; an
    unfused one K1 in int32 mode for each conv of at least 64 input
    channels.  An attention block of several heads is composed: K4 with
    three outputs, four K1 1x1 GEMMs and K11 with heads; one head routes as
    the DDPM's block (`_k3_site`).  conv_in runs on the fake-quant float
    conv, conv_out on K4 and K1's int32 3x3 mode."""
    from ..models.adm import adm_blocks, heads_of

    def rup(c):
        return (c + 127) // 128 * 128

    dot = torch.bfloat16 if dot_bf16 else torch.int32
    plan = {k: [] for k in ("K1", "K2", "K6", "K4", "K11", "K3", "plain")}
    for kind, name, H, cin, cout, rs in adm_blocks(cfg):
        if kind == "attn":
            heads = heads_of(cfg, cin)
            if cin < 64:
                plan["plain"].append((name, "fake-quant projections"))
                if heads > 1 or takes_flash(H * H, cin):
                    plan["K11"].append((name, H * H, cin, heads))
                continue
            if heads == 1 and _k3_site(H * H, cin):
                plan["K3"].append((name, H * H, cin))
                continue
            if fused_gn.gn_act_quant_takes(batch, H * H, cin, residual_dtype, 3):
                plan["K4"].append((name, H * H, cin))
            else:
                plan["plain"].append((name, "entry"))
            plan["K1"] += [(f"{name}.{s}", H, rup(cin), rup(cin), 1, torch.int32) for s in ("q", "k", "v", "proj_out")]
            if heads > 1 or takes_flash(H * H, cin):
                plan["K11"].append((name, H * H, cin, heads))
            continue
        Ho = H // 2 if rs == "down" else 2 * H if rs == "up" else H
        if fused_block(cin, cout):
            if rs == "down" or not fused_gn.gn_act_quant_takes(batch, H * H, cin, residual_dtype):
                plan["plain"].append((name, "entry"))
            else:
                plan["K4"].append((name, H * H, cin))
            plan["K1"].append((f"{name}.conv1", Ho, rup(cin), rup(cout), 3, dot))
            plan[fused_gn.epilogue_route((1, Ho, Ho, cout), dot)].append((name, Ho * Ho, cout))
            plan["K1"].append((f"{name}.conv2", Ho, rup(cout), rup(cout), 3, dot))
        else:
            plan["plain"].append((name, "unfused chain"))
            for conv, c_in, c_out in (("conv1", cin, cout), ("conv2", cout, cout)):
                if c_in >= 64:
                    plan["K1"].append((f"{name}.{conv}", Ho, rup(c_in), rup(c_out), 3, torch.int32))
        if cin != cout and cin >= 64:
            plan["K1"].append((f"{name}.nin_shortcut", Ho, rup(cin), rup(cout), 1, torch.int32))
    c0 = cfg.ch * cfg.ch_mult[0]
    if c0 >= 64:
        if fused_gn.gn_act_quant_takes(batch, cfg.resolution ** 2, c0, residual_dtype):
            plan["K4"].append(("conv_out", cfg.resolution ** 2, c0))
        plan["K1"].append(("conv_out", cfg.resolution, rup(c0), rup(cfg.out_ch), 3, torch.int32))
    return plan


def attention_sites(cfg) -> list:
    """(site, L, C) of every attention block of a serving step that the int8
    path covers (q projection eligible), in forward order; either variant."""
    from ..models.unet import ATTN_PROJS, iter_conv_layers
    from ..quant.int8_runtime import _eligible

    levels = len(cfg.ch_mult)
    first = ATTN_PROJS[cfg.attn_variant][0]
    sites = []
    for name, cin, k in iter_conv_layers(cfg):
        parts = name.split(".")
        if parts[-1] != first or not _eligible((k, k, cin, 0)):
            continue
        H = cfg.resolution >> (levels - 1 if parts[0] == "mid" else int(parts[1]))
        sites.append((name.rsplit(".", 1)[0], H * H, cin))
    return sites


def attention_plan(cfg, *, attn_int8=None, attn_ranges=None) -> dict:
    """The attention cores of one serving step under the attention flags, by
    the dispatchers' own predicates: {"K3.int8_core": [(L, C)], "K8": [...],
    "K9": [...], "K10": [...], "K11": [...], "refused": [(site, L, C,
    kernel)]}.  `attn_ranges`: the calibrated ranges' dict (or any container
    of projection names), or True for every site.  "refused" names the sites
    whose CUDA kernel would refuse the map (K3 off `k3_takes`, K8 / K9 / K10
    off `int8_core_takes`, K11 off `flash_takes` at `spatial_attention`'s key
    block): on the card `serving_ddim_sampler` raises with them before its
    first step (`require_attention_kernels`).  The int8 core
    of a composed site needs its projections unpadded (C % 128 == 0);
    otherwise the site takes the f32 branch, as `_attn_fused` does.  The
    enhanced variant's sites run no attention kernel (their cores are plain
    torch), so its plan is empty.  `attn_int8` None is the variant's own
    (True on the ddim one), as in `serving_unet_apply`."""
    from . import int8_attention as ia

    plan = {k: [] for k in ("K3.int8_core", "K8", "K9", "K10", "K11", "refused")}
    if cfg.attn_variant == "enhanced":
        return plan
    if cfg.model_type == "adm":  # the float32 core: K11 with heads where more than one (`adm_step_plan`)
        adm = adm_step_plan(cfg, 1)
        plan["K11"] = [(L, C) for _site, L, C, _heads in adm["K11"]]
        plan["refused"] = ([(site, L, C, "K3") for site, L, C in adm["K3"] if not ia.k3_takes(L, C)]
                           + [(site, L, C, "K11") for site, L, C, heads in adm["K11"]
                              if not flash_takes(L, C // heads, min(512, L), heads)])
        return plan
    attn_int8 = True if attn_int8 is None else attn_int8
    for site, L, C in attention_sites(cfg):
        if _k3_site(L, C):
            if attn_int8:
                plan["K3.int8_core"].append((L, C))
            if not ia.k3_takes(L, C):
                plan["refused"].append((site, L, C, "K3"))
            continue
        if not attn_int8 or C % 128:
            if takes_flash(L, C):
                plan["K11"].append((L, C))
                if not flash_takes(L, C):
                    plan["refused"].append((site, L, C, "K11"))
            continue
        static = attn_ranges is True or (
            attn_ranges is not None and all(f"{site}.{k}" in attn_ranges for k in ("q", "k", "v")))
        kind = ("K10" if ia.static_core_takes_flash(L, C) else "K9") if static else "K8"
        plan[kind].append((L, C))
        if not ia.int8_core_takes(L, C):
            plan["refused"].append((site, L, C, kind))
    return plan


def require_attention_kernels(cfg, device, *, attn_int8=None, attn_ranges=None):
    """Raise NotImplementedError, naming every site, where a serving step on
    `device` would reach an attention kernel that refuses its map; CPU
    tensors take the plain versions, which take any map."""
    if torch.device(device).type != "cuda":
        return
    refused = attention_plan(cfg, attn_int8=attn_int8, attn_ranges=attn_ranges)["refused"]
    if refused:
        raise NotImplementedError(
            "attention sites off the CUDA kernels' shapes (K3: C in (128, 256, 512, 1024), L <= 1024; K8 / K9 / K10: "
            "C in (128, 256, 512), L % 64 == 0; K11: C in (128, 256), L % 64 == 0): "
            + ", ".join(f"{site} (L={L}, C={C}) -> {kind}" for site, L, C, kind in refused))


def lever_plan(cfg, batch: int, *, entry_pallas=False, boundary_fusion=False, resblock_pallas=False,
               dot_bf16=True, residual_dtype=torch.float32) -> dict:
    """The sites of one serving step that run on K4, K7 and K12, from the
    config and the forward's own predicates (no tensors): {"K4": [(site,
    HW, C)], "K7": [(site, HW, N)], "K12": [(site, H, C)]}.  A site is a
    resblock's name, "conv_out" for its entry, or a composed attention
    block's name for its three-output entry.  K4 takes every entry of a
    `fused_block` that carries no K7 sums and is not K12's, conv_out's and
    the composed attention blocks', wherever `gn_act_quant_takes` admits
    the shape at the residual's dtype, at either value of `entry_pallas`
    (JAX's lever, which moves nothing here).  Only a `fused_block` takes
    the two other levers; K12 also needs `dot_bf16` (JAX's gate)."""
    del entry_pallas  # every entry K4 takes runs on it whatever its value
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
        if not fused_block(cin, cout):
            return
        if (resblock_pallas and dot_bf16 and not entry_sums and not want and cin == cout
                and resblock_pallas_fits(batch, H, H, cin)
                and (resblock_pallas == "all" or conv3_pallas_wins(batch, H, H, cin, cin))):
            plan["K12"].append((name, H, cin))
            return
        if not entry_sums and fused_gn.gn_act_quant_takes(batch, H * H, cin, residual_dtype):
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
    if cin_of["conv_out"] >= 64 and fused_gn.gn_act_quant_takes(batch, res[0] * res[0], cin_of["conv_out"],
                                                                residual_dtype):
        plan["K4"].append(("conv_out", res[0] * res[0], cin_of["conv_out"]))
    if cfg.attn_variant != "enhanced":  # the composed attention blocks' entries: no swish, three outputs
        plan["K4"] += [(site, L, C) for site, L, C in attention_sites(cfg)
                       if not _k3_site(L, C) and fused_gn.gn_act_quant_takes(batch, L, C, residual_dtype, 3)]
    return plan


def gn_refused(cfg, batch: int, *, residual_dtype=torch.float32, dot_bf16=True, **levers) -> list:
    """(site, HW, C, kernel) of every GroupNorm or resblock kernel call of one
    serving step at `batch`, the residual stream `residual_dtype` (bf16 or
    f32), `dot_bf16` and the levers given (`lever_plan`'s keywords) whose
    CUDA kernel would refuse its shape: a resblock epilogue off K2's and
    K6's plans for conv1's output (bf16, or int32 with `dot_bf16=False`;
    over the whole-image budget and off K6's grid `epilogue_route` sends it
    to K2, so it is refused only where K2's plan is; kernel "K2/K6"), a K7
    exit without a launch plan (`epilogue_residual_gn_stats_takes`: N above 1024,
    off the 8-channel grid, past 32 * 32 windows), a K12 block off
    `resblock_pallas_takes` at the residual's dtype.  No entry is refused:
    one that no form of K4 takes runs in plain torch.  On the card
    `serving_ddim_sampler` raises with them before its first step
    (`require_gn_kernels`)."""
    from ..models.unet import iter_conv_layers
    from .pallas_resblock import resblock_pallas_takes

    if residual_dtype not in fused_gn.RESIDUAL_DTYPES:
        raise ValueError(f"residual_dtype={residual_dtype!r}: the serving path's residual stream is bf16 or f32")
    if cfg.model_type == "adm":  # its conv1 epilogues (`adm_step_plan`); no K7 or K12
        adm = adm_step_plan(cfg, batch, dot_bf16=dot_bf16, residual_dtype=residual_dtype)
        dot = torch.bfloat16 if dot_bf16 else torch.int32
        refused = []
        for kind in ("K2", "K6"):
            for site, HW, N in adm[kind]:
                try:
                    fused_gn.epilogue_plan(batch, HW, N, dot, kind)
                except NotImplementedError:
                    refused.append((site, HW, N, "K2/K6"))
        return refused
    plan = lever_plan(cfg, batch, dot_bf16=dot_bf16, residual_dtype=residual_dtype, **levers)
    whole = {site for site, _H, _C in plan["K12"]}
    levels = len(cfg.ch_mult)
    dot = torch.bfloat16 if dot_bf16 else torch.int32
    refused = []
    for name, cin, k in iter_conv_layers(cfg):  # the conv1 epilogues of the fused blocks K12 does not take
        parts = name.split(".")
        block = name.rsplit(".", 1)[0]
        if parts[-1] != "conv1" or block in whole:
            continue
        lvl = levels - 1 if parts[0] == "mid" else int(parts[1])
        H, N = cfg.resolution >> lvl, cin if parts[0] == "mid" else cfg.ch * cfg.ch_mult[lvl]
        if not fused_block(cin, N):
            continue
        try:
            kind = fused_gn.epilogue_route((batch, H, H, N), dot)
            fused_gn.epilogue_plan(batch, H * H, N, dot, kind)
        except NotImplementedError:
            refused.append((block, H * H, N, "K2/K6"))
    refused += [(site, HW, N, "K7") for site, HW, N in plan["K7"]
                if not fused_gn.epilogue_residual_gn_stats_takes(HW, N)]
    refused += [(site, H * H, C, "K12") for site, H, C in plan["K12"]
                if not resblock_pallas_takes(batch, H, H, C, residual_dtype)]
    return refused


def require_gn_kernels(cfg, device, batch: int, **flags):
    """Raise NotImplementedError, naming every site, where a serving step on
    `device` at `batch` and these flags (`gn_refused`'s keywords) would reach
    a GroupNorm or resblock kernel that refuses its shape; CPU tensors take
    the plain versions, which take any shape."""
    if torch.device(device).type != "cuda":
        return
    refused = gn_refused(cfg, batch, **flags)
    if refused:
        raise NotImplementedError(
            "GroupNorm / resblock sites off the CUDA kernels' shapes (N or C a multiple of 8 up to 1024, HW up to "
            "2^20 rows): "
            + ", ".join(f"{site} (HW={HW}, C={C}) -> {kind}" for site, HW, C, kind in refused))


def expected_launches(cfg, steps: int = 1, batch: int = 1, *, attn_int8=None, attn_ranges=None,
                      residual_dtype=torch.float32, dot_bf16=True, conv_pallas=False, **levers) -> dict:
    """Launch counts of `steps` serving steps, per kernel (K13 and K5 are
    K1's int32 3x3 and 1x1 launches, "K3.int8_core" the K3 launches that ran
    the int8 core), under the attention flags
    (`attention_plan`'s keywords, the serving defaults), `dot_bf16` and the
    levers given
    (`lever_plan`'s keywords; none: the levers-off path).  A block K12 takes
    launches neither its two K1 convs nor its K2 / K6 epilogue; a composed
    attention site launches K1 four times and K4 once where it takes the
    map, an enhanced one K1 four times (in 1x1 int32 mode: K5), with no K3
    and no core kernel.  `residual_dtype` (bf16 or f32), `conv_pallas` and
    `entry_pallas` change no count; they are taken so that a sampler's
    flags pass whole."""
    del conv_pallas  # every int8 conv is K1 whatever its value
    if residual_dtype not in fused_gn.RESIDUAL_DTYPES:
        raise ValueError(f"residual_dtype={residual_dtype!r}: the serving path's residual stream is bf16 or f32")
    if cfg.model_type == "adm":  # `adm_step_plan`'s calls; no K7 / K12, no int8 core
        adm = adm_step_plan(cfg, batch, dot_bf16=dot_bf16, residual_dtype=residual_dtype)
        k1 = adm["K1"]
        counts = {key: 0 for key in launch_counters()}
        counts.update({"K1": len(k1), "K5": sum(1 for c in k1 if c[4] == 1),
                       "K13": sum(1 for c in k1 if c[4] == 3 and c[5] == torch.int32),
                       "K3.int8_core": 0, **{k: len(adm[k]) for k in ("K2", "K6", "K4", "K11", "K3")}})
        return {k: n * steps for k, n in counts.items()}
    k1, k2, k6, k3, _composed = conv_plan(cfg, dot_bf16=dot_bf16)
    attn = attention_plan(cfg, attn_int8=attn_int8, attn_ranges=attn_ranges)
    plan = lever_plan(cfg, batch, dot_bf16=dot_bf16, residual_dtype=residual_dtype, **levers)
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


def interception_launches(cfg, steps: int = 1) -> dict:
    """Launch counts of `steps` forwards of the interception runtime
    (`quant/int8_runtime.int8_model_fn`, `qunet` mode "int8"), per kernel,
    with `expected_launches`' keys: each conv the fold covers (at least 64
    input channels, stride 1) is one K1 launch in int32 mode, K13 for a 3x3
    conv and K5 for a 1x1; the downsample convs (stride 2) and the narrow
    convs run the fake-quant float conv.  The attention cores are the FP
    UNet's (`spatial_attention`): K11 where `takes_flash`, plain torch
    elsewhere.  No other kernel runs."""
    from ..models.unet import ATTN_PROJS, iter_conv_layers
    from ..quant.int8_runtime import _eligible

    levels = len(cfg.ch_mult)
    n3 = n1 = k11 = 0
    for name, cin, k in iter_conv_layers(cfg):
        parts = name.split(".")
        if parts[-1] == ATTN_PROJS[cfg.attn_variant][0] and cfg.attn_variant == "ddim":
            H = cfg.resolution >> (levels - 1 if parts[0] == "mid" else int(parts[1]))
            k11 += takes_flash(H * H, cin)
        if parts[-2:-1] == ["downsample"] or not _eligible((k, k, cin, 0)):
            continue
        n3 += k == 3
        n1 += k == 1
    counts = {key: 0 for key in launch_counters()}
    counts.update(K1=n1 + n3, K5=n1, K13=n3, K11=k11, **{"K3.int8_core": 0})
    return {key: n * steps for key, n in counts.items()}


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
