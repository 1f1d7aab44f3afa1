"""Operations and bytes of one serving step's kernel launches of ADM's UNet
(guided-diffusion's `UNetModel`), from the configuration's shapes: a frozen
copy of the arithmetic of the port's `ops/checks.adm_step_plan`, kept here
so that a change to the program cannot move the yardstick.

Launches as `ddpm_unet.py` counts them (`Work`, `conv_launch`): each K1
launch's input, weights and output once at the widths the conv needs; the
K2 / K6 epilogue of a fused resblock's conv1 output; each K4 entry (a
resblock's norm1 outside a downsampling block, each attention block's
three-output entry, norm_out); and the attention cores, K11 with heads:
q, k, v read and the output written once in float32, and their 4 L^2 C
float32-exact operations an image as 3xTF32 tensor-core work, the least
time a float32-exact product can take on the card and the rate K3's core
reaches (K11 runs its FMAs on the CUDA cores, but the yardstick prices the
work, not the kernel's choice).  "core" holds the same products: the
step's share of the card's peak counts them at that rate, as the DDPM's
does.
"""
from __future__ import annotations

from ..reference import adm_w4a8 as arch
from .ddpm_unet import GN_FLOPS, WHOLE_IMAGE_BYTES, Work, conv_launch, fused_block

K4_FLOPS = 12  # float32 operations an element of a GroupNorm entry (statistics, normalize, swish, quant)


def _entry(batch, HW, C, residual_bytes, n_out=1):
    return Work(batch * HW * C * (residual_bytes + n_out) + 4 * 2 * C * (1 + n_out),
                f32_flops=(K4_FLOPS + 3 * (n_out - 1)) * batch * HW * C)


def step_work(cfg: dict, batch: int, residual_bytes: int = 4, dot_bf16: bool = True) -> dict:
    """{"K1": [Work], "K2": [Work], "K6": [Work], "K4": [Work], "K11": [Work]
    (the attention cores), "K3": [Work] (none: ADM's blocks of several heads
    are composed), "core": [Work] (the cores' products as 3xTF32)} of one
    step at `batch`."""
    out = {"K1": [], "K2": [], "K6": [], "K4": [], "K11": [], "K3": [], "core": []}
    dot_bytes = 2 if dot_bf16 else 4
    d = cfg["model"]["num_head_channels"]
    for kind, _name, H, cin, cout, rs in arch.blocks(cfg):
        if kind == "attn":
            L, C = H * H, cin
            out["K4"].append(_entry(batch, L, C, residual_bytes, 3))
            out["K1"] += [conv_launch(batch, H, C, C, 1, 1, 4)] * 4
            out["K11"].append(Work(16 * batch * L * C, tf32x3_flops=4 * batch * L * L * C))
            out["core"].append(Work(tf32x3_flops=4 * batch * L * L * C))
            assert C % d == 0
            continue
        Ho = H // 2 if rs == "down" else 2 * H if rs == "up" else H
        if fused_block(cin, cout):
            if rs != "down":
                out["K4"].append(_entry(batch, H * H, cin, residual_bytes))
            out["K1"].append(conv_launch(batch, Ho, cin, cout, 3, 1, dot_bytes))
            HW = Ho * Ho
            route = "K2" if HW * cout * (dot_bytes + 1) <= WHOLE_IMAGE_BYTES else "K6"
            out[route].append(Work(batch * HW * cout * (dot_bytes + 1) + 4 * 7 * cout,
                                   f32_flops=GN_FLOPS * batch * HW * cout))
            out["K1"].append(conv_launch(batch, Ho, cout, cout, 3, 1, dot_bytes))
        else:
            out["K1"] += [conv_launch(batch, Ho, ci, cout, 3, 1, 4) for ci in (cin, cout) if ci >= 64]
        if cin != cout and cin >= 64:
            out["K1"].append(conv_launch(batch, Ho, cin, cout, 1, 1, 4))
    c0, res = cfg["model"]["num_channels"] * cfg["model"]["channel_mult"][0], cfg["data"]["image_size"]
    if c0 >= 64:
        out["K4"].append(_entry(batch, res * res, c0, residual_bytes))
        out["K1"].append(conv_launch(batch, res, c0, arch.out_channels(cfg), 3, 1, 4))
    return out
