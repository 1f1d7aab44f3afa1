"""Operations and bytes of one serving step's kernel launches of the DDPM UNet, from the
configuration's shapes: a frozen copy of the arithmetic of the port's
`ops/checks.conv_plan(widths=True)` / `bound_ms` and of `chip_smoke.py`'s
kernel bounds, kept here so that a change to the program cannot move the
yardstick.

Each launch is a `Work(nbytes, int8_ops, tf32x3_flops, f32_flops)`: every
input byte read once and every output byte written once at the widths the
conv needs (before any padding to 128 columns), int8 products at 2
operations a multiply-add, the attention core's float32 products as 3xTF32,
the epilogues' float32 arithmetic on the CUDA cores.
"""
from __future__ import annotations

from typing import NamedTuple

from ..reference import ddpm_w4a8 as arch
from .peaks import least_seconds

WHOLE_IMAGE_BYTES = 4 * 1024 * 1024  # an epilogue within this goes to K2, over it to K6 (the port's routing)
K3_BUDGET = 6 * 1024 * 1024  # an attention map within this runs as the whole-block kernel K3
GN_FLOPS = 18  # float32 operations an element of the GroupNorm epilogues (dequant, +temb, statistics, swish, quant)
K3_FLOPS_ELEM, K3_FLOPS_LOGIT = 30, 5  # float32 operations around K3's products, an element and a logit


class Work(NamedTuple):
    nbytes: float = 0.0
    int8_ops: float = 0.0
    tf32x3_flops: float = 0.0
    f32_flops: float = 0.0

    def seconds(self) -> float:
        return least_seconds(self.nbytes, self.int8_ops, self.tf32x3_flops, 0.0, self.f32_flops)


def k3_site(L: int, C: int) -> bool:
    return C % 128 == 0 and L >= 8 and 6 * L * C * 4 + L * L * 4 <= K3_BUDGET


def fused_block(cin: int, cout: int) -> bool:
    return cin >= 64 and cout >= 64 and cout % 128 == 0


def conv_launch(B, H, cin, cout, k, stride, out_bytes):
    """One K1 launch: input [B, H, H, cin] int8, weights k*k*cin*cout, output
    rows x cout at `out_bytes` (2: bf16 with the dequant fused, 4: int32)."""
    rows = B * (H // stride) ** 2
    fused = out_bytes == 2
    return Work(B * H * H * cin + k * k * cin * cout + rows * cout * out_bytes + (8 * cout if fused else 0),
                int8_ops=2 * rows * cout * k * k * cin, f32_flops=2 * rows * cout if fused else 0)


def step_work(cfg: dict, batch: int, residual_bytes: int = 4, dot_bf16: bool = True) -> dict:
    """{"K1": [Work] (every int8 conv / GEMM launch, K3's four included),
    "K2": [Work], "K6": [Work], "K3": [Work] (whole blocks), "core": [Work]
    (K3's attention products)} of one step at `batch`."""
    layout = arch.param_layout(cfg)
    out = {"K1": [], "K2": [], "K6": [], "K3": [], "core": []}
    dot_bytes = 2 if dot_bf16 else 4
    cin_of = {name: cin for name, cin, _k, _s, _h in arch.conv_sites(cfg)}
    for name, cin, k, stride, H in arch.conv_sites(cfg):
        if not arch.folded(cin, k):
            continue
        cout = arch.node(layout, name)["kernel"][0][3]
        parts = name.split(".")
        if ".attn" in name or name.startswith("mid.attn"):
            L, C = H * H, cin
            if not k3_site(L, C):
                out["K1"].append(conv_launch(batch, H, cin, cout, 1, 1, 4))
            elif parts[-1] == "q":
                rows = batch * L
                proj = Work(rows * C + C * C + 4 * rows * C + 8 * C, int8_ops=2 * rows * C * C, f32_flops=2 * rows * C)
                out_proj = Work(rows * C + C * C + 2 * residual_bytes * rows * C + 8 * C, int8_ops=2 * rows * C * C,
                                f32_flops=3 * rows * C)
                out["K1"] += [proj, proj, proj, out_proj]
                core = Work(tf32x3_flops=2 * 2 * batch * L * L * C)
                out["core"].append(core)
                out["K3"].append(Work(2 * residual_bytes * rows * C + 4 * C * C + 16 * 4 * C,
                                      int8_ops=4 * 2 * rows * C * C, tf32x3_flops=core.tf32x3_flops,
                                      f32_flops=K3_FLOPS_ELEM * rows * C + K3_FLOPS_LOGIT * batch * L * L))
            continue
        if parts[-1] in ("conv1", "conv2") and fused_block(cin_of[name.rsplit(".", 1)[0] + ".conv1"], cout):
            out["K1"].append(conv_launch(batch, H, cin, cout, k, stride, dot_bytes))
            if parts[-1] == "conv1":
                HW = H * H
                kind = "K2" if HW * cout * (dot_bytes + 1) <= WHOLE_IMAGE_BYTES else "K6"
                out[kind].append(Work(batch * HW * cout * (dot_bytes + 1) + 4 * 7 * cout,
                                      f32_flops=GN_FLOPS * batch * HW * cout))
            continue
        out["K1"].append(conv_launch(batch, H, cin, cout, k, stride, 4))
    return out
