"""The serving kernels against their plain versions: tolerances, the
per-site check of a serving step, and the launch plan of a config.

Used by `chip_smoke.py` and `tests/test_torch_gpu.py` on the card.

Tolerances, per kernel output against the plain version on the same inputs:
  K1 (K13, K5)  int32 out: equal; bf16 out: within 1 bf16 ulp everywhere
                (one rounding of the same f32 epilogue);
  K2, K6        int8 codes: at most 1 LSB apart, on at most 0.1% of them;
  K3            mean relative error < 1e-3 and at least 99% of the
                elements within 1 bf16 ulp (f32 sums in another order).
"""
from __future__ import annotations

import contextlib

import torch

from . import fused_gn


def compare(kind: str, got, want) -> dict:
    """Agreement figures of a kernel output with its plain version, and
    whether they meet the kernel's tolerance (`ok`)."""
    if kind == "K1" and got.dtype == torch.int32:
        err = (got - want).abs().max().item()
        return dict(max_abs_err=err, ok=err == 0)
    gf, wf = got.float(), want.float()
    d = (gf - wf).abs()
    err = d.max().item()
    if kind in ("K2", "K6"):
        frac = (d > 0).float().mean().item()
        return dict(max_abs_err=err, frac=frac, ok=err <= 1 and frac <= 1e-3)
    within = (d <= wf.abs() * 2.0 ** -7 + 1e-30).float().mean().item()
    if kind == "K1":
        return dict(max_abs_err=err, within=within, ok=within == 1.0)
    rel = (d.mean() / wf.abs().mean()).item()
    return dict(max_abs_err=err, rel=rel, within=within, ok=rel < 1e-3 and within >= 0.99)


@contextlib.contextmanager
def per_site(records: list):
    """Teacher-forced per-site check of the serving forward: while active,
    every kernel call of `quant/int8_serving.py` also runs its plain version
    on the same inputs and appends (kernel, output shape, figures) to
    `records`; the forward goes on with the kernel's output.  The plain
    calls launch nothing, so launch counts stay the kernels' own."""
    from ..quant import int8_serving as srv

    saved = {name: getattr(srv, name) for name in ("_k1", "epilogue_gn_swish_quant", "fused_attention_block")}

    def wrap(name, kind_of):
        fn = saved[name]

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            want = fn(*args, **{**kwargs, "plain": True})
            kind = kind_of(*args)
            records.append((kind, tuple(out.shape), compare(kind, out, want)))
            return out

        return call

    srv._k1 = wrap("_k1", lambda *a: "K1")
    srv.epilogue_gn_swish_quant = wrap("epilogue_gn_swish_quant",
                                       lambda dot, *a: fused_gn.epilogue_route(dot.shape, dot.dtype))
    srv.fused_attention_block = wrap("fused_attention_block", lambda *a: "K3")
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(srv, name, fn)


def conv_plan(cfg):
    """One serving step's kernel calls, derived from `iter_conv_layers` and
    the config: K1 launches (name, H_in, Cp, Np, ksize, stride, out dtype),
    the K2 and K6 epilogue shapes (HW, N), routed by `epilogue_route` on the
    bf16 conv1 output, and the K3 shapes (L, C)."""
    from ..models.unet import iter_conv_layers
    from ..quant.int8_runtime import _eligible

    def rup(c):
        return (c + 127) // 128 * 128

    levels = len(cfg.ch_mult)
    res = [cfg.resolution >> i for i in range(levels)]
    k1, epi, k3 = [], {"K2": [], "K6": []}, []
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
            if parts[-1] == "q":
                k3.append((H * H, cin))
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
    return k1, epi["K2"], epi["K6"], k3


def expected_launches(cfg, steps: int = 1) -> dict:
    """Launch counts of `steps` serving steps, per kernel (K13 and K5 are
    K1's int32 3x3 and 1x1 launches)."""
    k1, k2, k6, k3 = conv_plan(cfg)
    return {"K1": len(k1) * steps, "K2": len(k2) * steps, "K6": len(k6) * steps, "K3": len(k3) * steps,
            "K5": sum(1 for c in k1 if c[4] == 1) * steps,
            "K13": sum(1 for c in k1 if c[4] == 3 and c[5] == 1 and c[6] == torch.int32) * steps}


def launch_counters():
    """The kernel wrappers whose `.launches` count their kernels."""
    from .fused_gn import epilogue_gn_swish_quant_blocked, epilogue_gn_swish_quant_whole
    from .int8_attention import fused_attention_block
    from .pallas_conv import int8_conv

    return int8_conv, epilogue_gn_swish_quant_whole, epilogue_gn_swish_quant_blocked, fused_attention_block


def reset_launches():
    int8_conv, *rest = launch_counters()
    int8_conv.launches, int8_conv.launches_by_mode = 0, {}
    for fn in rest:
        fn.launches = 0


def read_launches() -> dict:
    int8_conv, k2, k6, k3 = launch_counters()
    by_mode = int8_conv.launches_by_mode
    return {"K1": int8_conv.launches, "K2": k2.launches, "K6": k6.launches, "K3": k3.launches,
            "K5": by_mode.get("1x1/s1/int32", 0), "K13": by_mode.get("3x3/s1/int32", 0)}
