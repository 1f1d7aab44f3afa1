"""Follow-up probes of the int8 conv roofline audit (`conv_roofline`), on
the card (port of `attentiondm_tpu/tools/conv_attack_probe.py`).

Two explanations for a conv shape off its roof, each probed by device time
(`probe.device_ms`: CUDA events around calls queued behind a spin kernel),
variants in one process:
  A. K1 reaches the tensor cores' rate only at some M = B H W tilings: the
     audit's worst shapes at batch 128 and 256 ("batch");
  B. the GEMM itself has a lower ceiling at these geometries: the raw int8
     GEMM at [M, 9C] x [9C, N], `torch._int_mm` on operands already in
     place, no patch tensor ("dot"); beside it the bf16 GEMM ceiling at one
     geometry ("bf16", `torch.matmul`).
Then K1 (JAX's "pallas" arm) at the step's conv3 shapes ("k1"), and the
census ("census"): for every distinct 3x3 stride-1 shape of the batch-128
headline step (`conv_roofline.conv_shape_table`, with its count), K1 against
the im2col route (patches + `torch._int_mm`), both in int32, held equal, and
which is faster.  That table is the data a Hopper `conv3_pallas_wins` would
need; the probe records it and changes no routing.

    python3 -m attentiondm_tpu_torch.tools.conv_attack_probe [--parts dot,batch,k1,bf16,census]
        [--batch 128] [--reps 10] [--device cpu] [--out FILE.json]
"""
from __future__ import annotations

import argparse
import collections

import torch

from ..models.unet import UNetConfig
from ..ops import checks
from ..ops.pallas_conv import int8_conv, k_major
from . import probe
from .conv_roofline import conv_shape_table, im2col_conv

PARTS = ("dot", "batch", "k1", "bf16", "census")


def _int8(shape, gen, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8)


def _row(label, ops, ms, nbytes, **kw):
    b_ms, o_ms = checks.bound_ms(nbytes, int8_ops=ops if kw.pop("int8", True) else 0,
                                 bf16_flops=0 if kw.get("dtype") != "bf16" else ops)
    return dict(label=label, ops=ops, ms=ms, tops=None if ms is None else ops / (ms * 1e-3) / 1e12,
                bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations", **kw)


def probe_dot(M, K, N, device, gen, reps):
    a, b = _int8((M, K), gen).to(device), _int8((K, N), gen, -8, 8).to(device)
    fn = (lambda: torch._int_mm(a, b)) if device.type == "cuda" else (
        lambda: (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32))
    return _row(f"int8 GEMM [{M},{K}]x[{K},{N}]", 2.0 * M * K * N, probe.kernel_ms(fn, device, reps=reps),
                M * K + K * N + 4 * M * N, M=M, K=K, N=N)


def probe_bf16(M, K, N, device, gen, reps):
    a = torch.randn((M, K), generator=gen).to(device, torch.bfloat16)
    b = torch.randn((K, N), generator=gen).to(device, torch.bfloat16)
    return _row(f"bf16 GEMM [{M},{K}]x[{K},{N}]", 2.0 * M * K * N,
                probe.kernel_ms(lambda: torch.matmul(a, b), device, reps=reps), 2 * (M * K + K * N + M * N),
                int8=False, dtype="bf16", M=M, K=K, N=N)


def _conv_inputs(B, res, C, N, device, gen):
    xp = _int8((B, res + 2, res + 2, C), gen).to(device)
    gq = _int8((9 * C, N), gen, -8, 8).to(device)
    return xp, gq, k_major(gq)


def probe_k1(B, res, C, N, device, gen, reps, out_dtype=torch.bfloat16):
    """K1 at a 3x3 stride-1 shape (bf16 out: the serving launch's epilogue)."""
    xp, gq, gqt = _conv_inputs(B, res, C, N, device, gen)
    inv_ws, zcb = torch.full((N,), 1e-2, device=device), torch.zeros(N, device=device)
    ms = probe.kernel_ms(lambda: int8_conv(xp, gq, inv_ws, zcb, ksize=3, out_dtype=out_dtype, gqt=gqt), device,
                        reps=reps)
    return _row(f"K1 conv3 B{B} {res}x{res} {C}->{N} ({str(out_dtype).split('.')[-1]} out)",
                2.0 * B * res * res * 9 * C * N, ms, xp.numel() + gq.numel() + B * res * res * N * (
                    2 if out_dtype == torch.bfloat16 else 4), B=B, res=res, C=C, N=N)


def census(batch, device, gen, reps):
    """Per distinct conv3 shape of the headline step: K1 and im2col, int32
    out, equal, timed in turns; the faster one and the step's totals."""
    counts = collections.Counter((s["res"], s["Cp"], s["Np"]) for s in conv_shape_table(UNetConfig(), batch)
                                 if s["variant"] == "conv3")
    rows = []
    for (res, C, N), cnt in counts.items():
        xp, gq, gqt = _conv_inputs(batch, res, C, N, device, gen)
        k1 = lambda: int8_conv(xp, gq, ksize=3, out_dtype=torch.int32, gqt=gqt)  # noqa: E731
        im = lambda: im2col_conv(xp, gq, 3, 1, res)  # noqa: E731
        equal = bool(torch.equal(k1(), im()))
        t = probe.interleaved({"k1": k1, "im2col": im}, device, rounds=reps, timer=probe.device_ms)
        t_k1, t_im = probe.median(t["k1"]), probe.median(t["im2col"])
        rows.append(dict(res=res, Cp=C, Np=N, count=cnt, equal=equal, k1_ms=t_k1, im2col_ms=t_im,
                         k1_wins=None if t_k1 is None else t_k1 < t_im,
                         ratio=None if t_k1 is None else t_im / t_k1))
    timed = device.type == "cuda"
    tot = dict(k1_ms=sum(r["k1_ms"] * r["count"] for r in rows) if timed else None,
               im2col_ms=sum(r["im2col_ms"] * r["count"] for r in rows) if timed else None,
               routed_ms=sum(min(r["k1_ms"], r["im2col_ms"]) * r["count"] for r in rows) if timed else None)
    return rows, tot


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--batch", type=int, default=128, help="the step's batch (the census, the dot geometries)")
    ap.add_argument("--reps", type=int, default=10)
    args = probe.add_common(ap).parse_args(argv)
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"conv_attack_probe: --parts among {', '.join(PARTS)}, got {args.parts!r}")
    device = probe.device_of(args.device)
    gen = torch.Generator().manual_seed(0)
    B = args.batch
    rec = {}
    if "dot" in parts:  # the im2col geometries of the audit's worst shapes, and a square-ish control
        rec["dot"] = [probe_dot(B * 16 * 16, 9 * 256, 256, device, gen, args.reps),
                      probe_dot(B * 32 * 32, 9 * 128, 128, device, gen, args.reps),
                      probe_dot(2 * B * 32 * 32, 9 * 128, 128, device, gen, args.reps),
                      probe_dot(B * 16 * 16, 2304, 2304, device, gen, args.reps)]
    if "batch" in parts:
        rec["batch"] = [probe_k1(b, res, C, N, device, gen, args.reps)
                        for b in (B, 2 * B) for res, C, N in ((16, 256, 256), (32, 128, 128))]
    if "k1" in parts:
        rec["k1"] = [probe_k1(B, res, C, N, device, gen, args.reps)
                     for res, C, N in ((16, 256, 256), (32, 128, 128), (8, 256, 256), (4, 256, 256))]
    if "bf16" in parts:
        rec["bf16"] = [probe_bf16(B * 16 * 16, 2304, 256, device, gen, args.reps)]
    if "census" in parts:
        rec["census"], rec["census_totals"] = census(B, device, gen, max(3, args.reps // 2))
    for part in ("dot", "batch", "k1", "bf16"):
        for r in rec.get(part, []):
            print(f"{r['label']:52s} " + ("-" if r["ms"] is None else
                                          f"{r['ms']:.4f} ms ({r['tops']:.0f} TOP/s, bound {r['bound_ms']:.4f} ms)"))
    for r in rec.get("census", []):
        print(f"census {r['res']}^2 {r['Cp']}->{r['Np']} x{r['count']}: K1 {r['k1_ms']} ms, im2col {r['im2col_ms']} ms"
              f" -> {'K1' if r['k1_wins'] else 'im2col' if r['k1_wins'] is not None else '-'}")
    return probe.emit("conv_attack_probe", device, args, rec, args.out)


if __name__ == "__main__":
    main()
