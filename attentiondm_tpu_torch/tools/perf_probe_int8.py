"""Cost split of the int8 path at CIFAR-10's level-0 shape, on the card
(port of `attentiondm_tpu/tools/perf_probe_int8.py`).

At batch 256, 32x32, C 128 (`--batch`, `--res`, `--ch`), each piece's
device time alone (`--reps` calls queued behind a spin kernel between CUDA
events, `probe.device_ms`: the wrapper's host time left out), in one
process:
  - GroupNorm (f32), GroupNorm + swish (`models.unet`);
  - the activation quantize -> int8 -> dequantize round trip;
  - the f32 3x3 conv (cuDNN, full f32) against the int8 pieces: the fold
    (`fold_weights_int8`), the interception conv
    (`quantized_conv2d_int8_prefolded`: quantize + K13 + dequant), K13 alone
    (K1's int32 3x3 on a quantized halo'd input), K1 with its fused dequant
    to bf16 (the serving conv), K2 (dequant + temb + GroupNorm + swish +
    int8 quant, the serving epilogue);
  - a resblock through the interception convs against the f32 resblock.
Each row carries its least time (`ops.checks`' H100 figures).

    python3 -m attentiondm_tpu_torch.tools.perf_probe_int8 [--batch 256] [--res 32] [--ch 128]
        [--reps 10] [--device cpu] [--out FILE.json]
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..models.unet import group_norm, swish
from ..ops import checks
from ..ops.fused_gn import epilogue_gn_swish_quant
from ..ops.pallas_conv import int8_conv, k_major
from ..ops.precision import exact_f32
from ..ops.quant_conv import (_quantize_padded, conv3x3_int8_dot, fold_weights_int8,
                              quantized_conv2d_int8_prefolded, zcorr_from_fold)
from . import probe

A_BIT, W_BIT = 8, 4


def pieces(B, H, C, device, gen):
    """{label: (fn, bytes, {op kind: count})} of every piece at the shape."""
    x = torch.randn((B, H, H, C), generator=gen).to(device)
    kernel = (torch.randn((3, 3, C, C), generator=gen) * 0.05).to(device)
    bias = (torch.randn(C, generator=gen) * 0.01).to(device)
    gn = {"scale": torch.ones(C, device=device), "bias": torch.zeros(C, device=device)}
    temb = (torch.randn((B, C), generator=gen) * 0.1).to(device)
    n_lv = 2 ** A_BIT - 1
    rmin, rmax = torch.full((C,), -4.0, device=device), torch.full((C,), 4.0, device=device)
    scale = n_lv / (rmax - rmin)
    zp = torch.round(scale * rmin) + 2 ** (A_BIT - 1)
    gq, ws, wzp, g_hat = fold_weights_int8(kernel, scale, W_BIT, symmetric=True)
    zc = zcorr_from_fold(g_hat, zp, 3, C)
    gqt = k_major(gq)
    Cp, Np = gq.shape[0] // 9, gq.shape[1]
    xq = _quantize_padded(x, scale, zp, A_BIT, 3, Cp)
    inv_ws, zcbias = 1.0 / ws, zc + F.pad(bias, (0, Np - C))
    dot_bf16 = int8_conv(xq, gq, inv_ws, zcbias, ksize=3, out_dtype=torch.bfloat16, gqt=gqt)

    def quant_roundtrip():
        n = 2 ** (A_BIT - 1)
        q = torch.clamp(torch.round(scale * x - zp), -n, n - 1).to(torch.int8)
        return (q.to(torch.float32) + zp) / scale

    def conv_f32(h):
        with exact_f32():
            return F.conv2d(h.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1) + bias

    def conv_int8(h):
        return quantized_conv2d_int8_prefolded(h, gq, ws, wzp, zc, bias, scale, zp, A_BIT, 3, C, symmetric=True,
                                               gqt=gqt)

    def resblock(conv):
        h = conv(swish(group_norm(x, gn)))
        h = swish(group_norm(h + temb[:, None, None, :], gn))
        return x + conv(h)

    act, w = B * H * H * C, 9 * C * C
    conv_ops = 2.0 * B * H * H * 9 * C * C
    return {
        "group_norm (f32)": (lambda: group_norm(x, gn), 8 * act, {"f32": 8.0 * act}),
        "group_norm + swish (f32)": (lambda: swish(group_norm(x, gn)), 8 * act, {"f32": 12.0 * act}),
        "quantize -> int8 -> dequantize": (quant_roundtrip, 8 * act, {"f32": 6.0 * act}),
        "f32 conv 3x3 (cuDNN, full f32)": (lambda: conv_f32(x), 8 * act + 4 * w, {"f32": conv_ops}),
        "fold (fold_weights_int8)": (lambda: fold_weights_int8(kernel, scale, W_BIT, symmetric=True), 4 * w + w,
                                     {"f32": 6.0 * w}),
        "int8 conv, interception (quantize + K13 + dequant)": (lambda: conv_int8(x), 8 * act + w, {"int8": conv_ops}),
        "K13 alone (K1 int32 3x3 on a quantized input)": (lambda: conv3x3_int8_dot(xq, gq, wqt=gqt),
                                                          xq.numel() + w + 4 * B * H * H * Np, {"int8": conv_ops}),
        "K1 bf16 out (fused dequant, the serving conv)": (
            lambda: int8_conv(xq, gq, inv_ws, zcbias, ksize=3, out_dtype=torch.bfloat16, gqt=gqt),
            xq.numel() + w + 2 * B * H * H * Np, {"int8": conv_ops}),
        "K2 (dequant + temb + GroupNorm + swish + quant)": (
            lambda: epilogue_gn_swish_quant(dot_bf16, inv_ws, zcbias, temb, gn["scale"], gn["bias"], scale, zp, A_BIT),
            3 * B * H * H * Np, {"f32": 12.0 * act}),
        "resblock int8 (interception convs)": (lambda: resblock(conv_int8), 16 * act + 2 * w,
                                               {"int8": 2 * conv_ops}),
        "resblock f32": (lambda: resblock(conv_f32), 16 * act + 8 * w, {"f32": 2 * conv_ops}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--ch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    args = probe.add_common(ap).parse_args(argv)
    device = probe.device_of(args.device)
    rows = []
    for label, (fn, nbytes, ops) in pieces(args.batch, args.res, args.ch, device,
                                           torch.Generator().manual_seed(0)).items():
        ms = probe.kernel_ms(fn, device, reps=args.reps)
        b_ms, o_ms = checks.bound_ms(nbytes, int8_ops=ops.get("int8", 0), f32_flops=ops.get("f32", 0))
        rows.append(dict(piece=label, ms=ms, bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations"))
        print(f"{label:55s} " + ("-" if ms is None else f"{ms:8.4f} ms (bound {max(b_ms, o_ms):.4f} ms)"))
    return probe.emit("perf_probe_int8", device, args, {"shape": [args.batch, args.res, args.res, args.ch],
                                                         "rows": rows}, args.out)


if __name__ == "__main__":
    main()
