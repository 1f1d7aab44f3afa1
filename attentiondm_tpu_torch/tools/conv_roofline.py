"""Per-shape int8 conv roofline audit at the headline operating point, on
the card (port of `attentiondm_tpu/tools/conv_roofline.py`).

Where does the int8 conv core's time go?  This probe
  1. lists every int8 conv the CIFAR-10 headline serving step runs (batch
     128, W4A8, DDIM-100): its padded shape, lowering (halo 3x3 "conv3",
     stride-2 "down2", the upsample's 3x3, 1x1 "conv1") and count per step,
     from `ops.checks.conv_plan` (equal to JAX's `conv_shape_table`);
  2. times K1 (`ops.pallas_conv.int8_conv`, the serving launch: its output
     mode as the step runs it) per distinct shape: its device time, `--reps`
     calls queued behind a spin kernel between CUDA events
     (`probe.device_ms`);
  3. reports the achieved int8 TOP/s against the shape's least time, the
     larger of its operations over the int8 tensor-core peak and its bytes
     over the memory rate (`ops.checks`' H100 figures);
  4. A/Bs two other lowerings of the same conv to int32: im2col (the 9
     shifted views concatenated, one `torch._int_mm`) and shift-and-add (nine
     K1 1x1 launches over the shifted views, summed), each held equal to
     K1's int32 mode.

    python3 -m attentiondm_tpu_torch.tools.conv_roofline [--batch 128] [--variants k1,im2col,shifted]
        [--reps 10] [--device cpu] [--out FILE.json]
"""
from __future__ import annotations

import argparse
import collections

import torch

from ..models.unet import UNetConfig
from ..ops import checks
from ..ops.pallas_conv import int8_conv, k_major
from . import probe


def conv_shape_table(cfg=None, batch: int = 128):
    """Every int8 conv of one serving step in call order, as JAX's
    `conv_shape_table` lists it: {name, variant, res (input side), cin,
    cout, k, Cp, Np (padded to 128), batch}, from the K1 launches of
    `ops.checks.conv_plan` other than the attention projections (the whole
    attention block covers those where it fits, as at CIFAR's shapes)."""
    cfg = cfg or UNetConfig()
    rows = []
    for name, H, Cp, Np, k, stride, _mode, cin, cout in checks.conv_plan(cfg, widths=True)[0]:
        if ".attn" in name or name.startswith("mid.attn"):
            continue
        variant = "conv1" if k == 1 else "down2" if stride == 2 else "conv3"
        rows.append(dict(name=name, variant=variant, res=H, cin=cin, cout=cout, k=k, Cp=Cp, Np=Np, batch=batch))
    return rows


def _modes(cfg):
    """{name: K1's output dtype in the serving step}."""
    return {name: mode for name, _H, _Cp, _Np, _k, _s, mode in checks.conv_plan(cfg)[0]}


def _geometry(site):
    B, res, k = site["batch"], site["res"], site["k"]
    stride = 2 if site["variant"] == "down2" else 1
    Ho = res // stride
    Hp = res + 2 if (k == 3 and stride == 1) else res + 1 if k == 3 else res
    return B, Hp, Ho, k, stride


def roofline(site) -> dict:
    """The shape's work and least time: 2 B Ho Wo k^2 Cp Np int8 operations;
    the padded input and the weights read once, the output written once."""
    B, Hp, Ho, k, _ = _geometry(site)
    ops = 2.0 * B * Ho * Ho * k * k * site["Cp"] * site["Np"]
    out_bytes = B * Ho * Ho * site["Np"] * (2 if site.get("mode") == torch.bfloat16 else 4)
    nbytes = B * Hp * Hp * site["Cp"] + k * k * site["Cp"] * site["Np"] + out_bytes
    b_ms, o_ms = checks.bound_ms(nbytes, int8_ops=ops)
    return dict(ops=ops, bytes=nbytes, bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations")


def _views(xp, k, stride, Ho):
    """The k*k shifted (strided) views of a padded input, tap-major as the fold's rows."""
    return [xp[:, dy:dy + stride * (Ho - 1) + 1:stride, dx:dx + stride * (Ho - 1) + 1:stride, :]
            for dy in range(k) for dx in range(k)]


def im2col_conv(xp, gq, k, stride, Ho):
    """int32 conv as one int8 GEMM: the shifted views concatenated along C,
    [B Ho Wo, k^2 Cp] x [k^2 Cp, Np] by `torch._int_mm`."""
    B = xp.shape[0]
    patches = torch.cat(_views(xp, k, stride, Ho), dim=-1).reshape(B * Ho * Ho, -1)
    if xp.is_cuda:
        dot = torch._int_mm(patches, gq)
    else:  # torch._int_mm is CUDA's; the CPU takes the exact integer product
        dot = (patches.to(torch.int64) @ gq.to(torch.int64)).to(torch.int32)
    return dot.reshape(B, Ho, Ho, -1)


def shifted_conv(xp, gq, k, stride, Ho):
    """int32 conv as k^2 accumulated 1x1 K1 launches over the shifted views
    (no patch tensor)."""
    Cp = xp.shape[-1]
    acc = None
    for tap, v in enumerate(_views(xp, k, stride, Ho)):
        d = int8_conv(v.contiguous(), gq[tap * Cp:(tap + 1) * Cp], ksize=1, out_dtype=torch.int32)
        acc = d if acc is None else acc + d
    return acc


def audit(cfg, batch: int, variants, device, reps: int = 10, gen=None):
    """One row per distinct (variant, res, Cp, Np, k) of the step: its count,
    bound and each lowering's time and TOP/s; every lowering's int32 output
    equal to K1's int32 mode."""
    gen = gen or torch.Generator().manual_seed(0)
    modes = _modes(cfg)
    groups = collections.OrderedDict()
    for s in conv_shape_table(cfg, batch):
        key = (s["variant"], s["res"], s["Cp"], s["Np"], s["k"])
        g = groups.setdefault(key, dict(site=dict(s, mode=modes[s["name"]]), count=0, names=[]))
        g["count"] += 1
        g["names"].append(s["name"])
    rows = []
    for key, g in groups.items():
        s = g["site"]
        B, Hp, Ho, k, stride = _geometry(s)
        xp = torch.randint(-128, 128, (B, Hp, Hp, s["Cp"]), generator=gen, dtype=torch.int8).to(device)
        gq = torch.randint(-8, 8, (k * k * s["Cp"], s["Np"]), generator=gen, dtype=torch.int8).to(device)
        inv_ws = (torch.rand(s["Np"], generator=gen) * 1e-3 + 1e-4).to(device)
        zcbias = torch.randn(s["Np"], generator=gen).to(device)
        gqt = k_major(gq)
        roof = roofline(s)
        ref = int8_conv(xp, gq, inv_ws, zcbias, ksize=k, stride=stride, out_dtype=torch.int32, gqt=gqt)
        fns = {"k1": lambda: int8_conv(xp, gq, inv_ws, zcbias, ksize=k, stride=stride, out_dtype=s["mode"], gqt=gqt),
               "im2col": lambda: im2col_conv(xp, gq, k, stride, Ho),
               "shifted": lambda: shifted_conv(xp, gq, k, stride, Ho)}
        row = dict(shape=list(key), count=g["count"], example=g["names"][0], k1_out=str(s["mode"]).split(".")[-1],
                   ops=roof["ops"], bytes=roof["bytes"], bound_ms=roof["bound_ms"], bound_by=roof["bound_by"])
        for v in variants:
            if v != "k1":
                row[f"{v}_equal"] = bool(torch.equal(fns[v](), ref))
            ms = probe.kernel_ms(fns[v], device, reps=reps)
            row[f"{v}_ms"] = ms
            row[f"{v}_tops"] = None if ms is None else roof["ops"] / (ms * 1e-3) / 1e12
            row[f"{v}_bound_share"] = None if ms is None else roof["bound_ms"] / ms
        rows.append(row)
        del xp, gq, ref
    totals = {v: None if device.type != "cuda" else sum(r[f"{v}_ms"] * r["count"] for r in rows) for v in variants}
    return rows, totals, sum(r["bound_ms"] * r["count"] for r in rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--variants", default="k1,im2col,shifted")
    ap.add_argument("--reps", type=int, default=10)
    args = probe.add_common(ap).parse_args(argv)
    device = probe.device_of(args.device)
    variants = args.variants.split(",")
    if not set(variants) <= {"k1", "im2col", "shifted"}:
        raise SystemExit(f"conv_roofline: --variants among k1, im2col, shifted, got {args.variants!r}")
    rows, totals, bound_total = audit(UNetConfig(), args.batch, variants, device, reps=args.reps)
    for r in rows:
        cells = "  ".join(f"{v} {r[f'{v}_ms']:.4f} ms ({r[f'{v}_tops']:.0f} TOP/s)" if r.get(f"{v}_ms") else f"{v} -"
                          for v in variants)
        print(f"{str(tuple(r['shape'])):32s} x{r['count']:<2d} bound {r['bound_ms']:.4f} ms [{r['bound_by']}]  {cells}")
    return probe.emit("conv_roofline", device, args, {"rows": rows, "step_totals_ms": totals,
                                                       "step_bound_ms": bound_total}, args.out)


if __name__ == "__main__":
    main()
