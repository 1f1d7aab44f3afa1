"""The yardstick's operations and bytes against hand counts of ddpm-cifar10
at batch 256, and its launch lists against the port's own counts."""
import json

import pytest

from portbench.roofline import ddpm_unet as W
from portbench.roofline.peaks import HBM_BYTES_PER_S, INT8_OPS_PER_S, TF32X3_FLOPS_PER_S, least_seconds

from .conftest import ROOT

B = 256


def config(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def test_a_3x3_conv_by_hand():
    # down.0.block.0.conv1: 32x32, 128 -> 128, bf16 out with its dequant fused
    w = W.conv_launch(B, 32, 128, 128, 3, 1, 2)
    rows = B * 32 * 32
    assert w.nbytes == B * 32 * 32 * 128 + 9 * 128 * 128 + rows * 128 * 2 + 8 * 128
    assert w.int8_ops == 2 * rows * 128 * 9 * 128 == 77_309_411_328
    assert w.f32_flops == 2 * rows * 128
    assert w.seconds() == pytest.approx(w.int8_ops / INT8_OPS_PER_S)  # bound by its products


def test_a_1x1_gemm_by_hand():
    # down.1.block.0.nin_shortcut: 16x16, 128 -> 256, int32 out
    w = W.conv_launch(B, 16, 128, 256, 1, 1, 4)
    rows = B * 16 * 16
    assert (w.nbytes, w.int8_ops, w.f32_flops) == (rows * 128 + 128 * 256 + rows * 256 * 4, 2 * rows * 256 * 128, 0)
    assert w.seconds() == pytest.approx(w.nbytes / HBM_BYTES_PER_S)  # bound by its bytes


def test_a_k3_site_by_hand():
    work = W.step_work(config("ddpm-cifar10"), B)
    L, C = 16 * 16, 256
    k3 = work["K3"][0]
    assert k3.nbytes == 2 * 4 * B * L * C + 4 * C * C + 16 * 4 * C
    assert k3.int8_ops == 4 * 2 * B * L * C * C and k3.tf32x3_flops == 2 * 2 * B * L * L * C
    assert k3.f32_flops == 30 * B * L * C + 5 * B * L * L
    assert k3.seconds() == pytest.approx(k3.int8_ops / INT8_OPS_PER_S + k3.tf32x3_flops / TF32X3_FLOPS_PER_S)
    assert work["core"][0].tf32x3_flops == k3.tf32x3_flops
    assert least_seconds(nbytes=3.35e12) == 1.0


@pytest.mark.parametrize("name,batch", [("ddpm-cifar10", 256), ("ddpm-lsun-church", 32)])
def test_launch_lists_match_the_ports_counts(name, batch):
    """K1's list holds each int8 conv launch and K3's four GEMMs; K2 / K6 /
    K3 one entry a launch, as the port's `expected_launches` counts them."""
    from attentiondm_tpu_torch.config import dict2namespace
    from attentiondm_tpu_torch.models.unet import UNetConfig
    from attentiondm_tpu_torch.ops.checks import expected_launches

    cfg = config(name)
    ucfg = UNetConfig.from_config(dict2namespace({k: cfg[k] for k in ("model", "data", "diffusion")}))
    want = expected_launches(ucfg, 1, batch, attn_int8=False)
    work = W.step_work(cfg, batch)
    assert len(work["K1"]) == want["K1"] + 4 * want["K3"]
    assert (len(work["K2"]), len(work["K6"]), len(work["K3"])) == (want["K2"], want["K6"], want["K3"])
