"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `gpu`: every test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is missing
(tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Each kernel is held to its tolerance against its plain version
(`attentiondm_tpu_torch.ops.checks`): K1 exact (int32) or within 1 bf16 ulp,
K2, K6 and K4 at most 1 int8 LSB on at most 0.1% of the codes, K3 mean
relative error < 1e-3 with 99% of the elements within 1 bf16 ulp, K7 within
1 bf16 ulp with sums within 1e-6 relative, K12 mean relative error < 1e-3
with 99.9% within 1 bf16 ulp."""
import pytest
import torch

import numpy as np

from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_init
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.ops.fused_gn import (
    epilogue_gn_swish_quant,
    epilogue_gn_swish_quant_blocked,
    epilogue_gn_swish_quant_whole,
    epilogue_residual_gn_stats,
    gn_act_quant,
)
from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
from attentiondm_tpu_torch.ops.pallas_conv import int8_conv
from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas
from attentiondm_tpu_torch.quant.int8_serving import prepare_serving_runtime, serving_unet_apply
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

pytestmark = pytest.mark.gpu

TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
# church-shaped: K6 at 128^2, K3 at C = 512
CHURCH_TOY = dict(ch=128, ch_mult=(1, 1, 1, 4), num_res_blocks=1, attn_resolutions=(16,), resolution=128,
                  dropout=0.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


def _i8(gen, shape, lo, hi, dev):
    return torch.randint(lo, hi + 1, shape, generator=gen, dtype=torch.int8).to(dev)


def _f(gen, shape, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen) * scale + shift).to(dev)


@pytest.mark.parametrize("ksize,stride,out_dtype,Cp,Np", [
    (3, 1, torch.int32, 128, 128), (3, 1, torch.bfloat16, 384, 256), (3, 2, torch.int32, 256, 256),
    (1, 1, torch.int32, 512, 128),
])
def test_k1_kernel_matches_plain(dev, gen, ksize, stride, out_dtype, Cp, Np):
    H = 8
    Hp = H + 2 if ksize == 3 and stride == 1 else H + 1 if ksize == 3 else H
    xp = _i8(gen, (3, Hp, Hp, Cp), -128, 127, dev)
    gq = _i8(gen, (ksize * ksize * Cp, Np), -8, 7, dev)
    inv_ws, zcbias = _f(gen, (Np,), dev, 1e-4, 5e-4).abs(), _f(gen, (Np,), dev)
    kw = dict(ksize=ksize, stride=stride, out_dtype=out_dtype)
    before = int8_conv.launches
    got = int8_conv(xp, gq, inv_ws, zcbias, **kw)
    assert int8_conv.launches == before + 1
    assert torch.equal(got, int8_conv(xp, gq, inv_ws, zcbias, **kw, plain=True))


def _epilogue_args(gen, dev, B, H, N, x_dtype):
    if x_dtype == torch.int32:
        dot = torch.randint(-20000, 20000, (B, H, H, N), generator=gen, dtype=torch.int32).to(dev)
        inv_ws, zcbias = _f(gen, (N,), dev, 2e-5, 1e-4).abs(), _f(gen, (N,), dev)
    else:
        dot = _f(gen, (B, H, H, N), dev, 1.5, 0.2).to(torch.bfloat16)
        inv_ws, zcbias = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    return (dot, inv_ws, zcbias, _f(gen, (B, N), dev), _f(gen, (N,), dev, 0.1, 1.0), _f(gen, (N,), dev, 0.1),
            torch.full((N,), 255 / 4.0, device=dev), torch.full((N,), -4.0, device=dev), 8)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("HW,N", [(1024, 128), (16, 256), (65536, 128)])
def test_k2_kernel_matches_plain(dev, gen, HW, N, x_dtype):
    """K2 at CIFAR shapes through the router, and called directly at K6's
    256^2 shape (where the path takes K6; the smoke times the two there)."""
    args = _epilogue_args(gen, dev, 4, int(HW ** 0.5), N, x_dtype)
    fn = epilogue_gn_swish_quant if HW <= 1024 else epilogue_gn_swish_quant_whole
    before = epilogue_gn_swish_quant_whole.launches
    got = fn(*args)
    assert epilogue_gn_swish_quant_whole.launches == before + 1
    fig = checks.compare("K2", got, fn(*args, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("H", [256, 128])
def test_k6_kernel_matches_plain(dev, gen, H, x_dtype):
    """K6 at the church shapes (N = 128), one channel group at a large
    offset (mean 40): E[x^2] - mu^2 cancels there."""
    args = list(_epilogue_args(gen, dev, 2, H, 128, x_dtype))
    args[2] = args[2].clone()
    args[2][:4] += 40.0
    before = (epilogue_gn_swish_quant_whole.launches, epilogue_gn_swish_quant_blocked.launches)
    got = epilogue_gn_swish_quant(*args)
    assert (epilogue_gn_swish_quant_whole.launches, epilogue_gn_swish_quant_blocked.launches) == (before[0], before[1] + 1)
    fig = checks.compare("K6", got, epilogue_gn_swish_quant_blocked(*args, plain=True))
    assert fig["ok"], fig


def test_k6_raises_off_its_grid(dev):
    """Over the whole-image budget, N off the 128 grid: JAX's XLA reference
    shape, not ported; the CUDA tensor raises instead of falling back."""
    N = 96
    dot = torch.zeros((1, 128, 128, N), dtype=torch.bfloat16, device=dev)
    v = torch.ones(N, device=dev)
    with pytest.raises(NotImplementedError):
        epilogue_gn_swish_quant(dot, v, v, torch.zeros((1, N), device=dev), v, v, v, v, 8)
    with pytest.raises(NotImplementedError):
        epilogue_gn_swish_quant_blocked(dot, v, v, torch.zeros((1, N), device=dev), v, v, v, v, 8)


def _k3_args(gen, dev, B, L, C):
    x = _f(gen, (B, L, C), dev, 2.0, 0.3).to(torch.bfloat16)

    def quant(a_bit, r):
        return (torch.full((C,), (2 ** a_bit - 1) / (2 * r), device=dev), torch.zeros(C, device=dev), a_bit)

    def weights():
        return _i8(gen, (C, C), -8, 7, dev), _f(gen, (C,), dev, 5e-5, 2e-4).abs(), _f(gen, (C,), dev, 0.1)

    return (x, _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev, 0.1), [quant(8, 4), quant(6, 4), quant(8, 4)],
            [weights() for _ in range(3)], quant(8, 3), weights())


@pytest.mark.parametrize("L,C", [(256, 256), (16, 256), (64, 128), (256, 512), (64, 512)])
def test_k3_kernel_matches_plain(dev, gen, L, C):
    args = _k3_args(gen, dev, 4, L, C)
    before = fused_attention_block.launches
    got = fused_attention_block(*args, scale=C ** -0.5)
    assert fused_attention_block.launches == before + 1
    fig = checks.compare("K3", got, fused_attention_block(*args, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


def test_k3_raises_off_its_widths(dev, gen):
    with pytest.raises(NotImplementedError):
        fused_attention_block(*_k3_args(gen, dev, 1, 16, 384), scale=384 ** -0.5)


def _quant(dev, C, a_bit, lo, hi):
    scale = (2 ** a_bit - 1) / (hi - lo)
    return (torch.full((C,), scale, device=dev), torch.full((C,), round(scale * lo) + 2.0 ** (a_bit - 1), device=dev),
            a_bit)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("HW,C,n_out,act", [(1024, 128, 1, "swish"), (256, 1024, 1, "swish"), (64, 768, 1, "swish"),
                                            (16, 384, 2, "swish"), (256, 256, 3, "none"), (4096, 128, 1, "swish")])
def test_k4_kernel_matches_plain(dev, gen, HW, C, n_out, act, x_dtype):
    """K4 at entry shapes of both models (C up to 1024, off the 512 grid at
    384 and 768), one to three outputs, with and without swish; the first
    channel group sits at a large offset, where E[x^2] - mu^2 cancels."""
    x = _f(gen, (3, HW, C), dev, 2.0, 0.3)
    x[..., :C // 32] += 40.0
    x = x.to(x_dtype)
    qp = [_quant(dev, C, b, -1.0, 4.0) for b in (8, 6, 8)[:n_out]]
    args = (x, _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev, 0.1), qp)
    before = gn_act_quant.launches
    got = gn_act_quant(*args, act=act)
    assert gn_act_quant.launches == before + 1 and len(got) == n_out
    fig = checks.compare("K4", got, gn_act_quant(*args, act=act, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("dot_dtype,res_dtype,out_dtype", [
    (torch.bfloat16, torch.float32, torch.bfloat16), (torch.int32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32), (torch.int32, torch.float32, torch.float32)])
@pytest.mark.parametrize("HW,N", [(1024, 128), (64, 256), (16, 512)])
def test_k7_kernel_matches_plain(dev, gen, HW, N, dot_dtype, res_dtype, out_dtype):
    B, H = 3, int(HW ** 0.5)
    if dot_dtype == torch.int32:
        dot = torch.randint(-20000, 20000, (B, H, H, N), generator=gen, dtype=torch.int32).to(dev)
        inv_ws, zcbias = _f(gen, (N,), dev, 2e-5, 1e-4).abs(), _f(gen, (N,), dev)
    else:
        dot = _f(gen, (B, H, H, N), dev, 1.5, 0.2).to(torch.bfloat16)
        inv_ws, zcbias = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    x_res = _f(gen, (B, H, H, N), dev, 2.0, 0.5).to(res_dtype)
    before = epilogue_residual_gn_stats.launches
    got = epilogue_residual_gn_stats(dot, inv_ws, zcbias, x_res, out_dtype=out_dtype)
    assert epilogue_residual_gn_stats.launches == before + 1
    assert got[0].dtype == out_dtype and tuple(got[1].shape) == (B, 2, 32)
    fig = checks.compare("K7", got, epilogue_residual_gn_stats(dot, inv_ws, zcbias, x_res, out_dtype=out_dtype,
                                                                plain=True))
    assert fig["ok"], fig


def _k12_args(gen, dev, B, H, C):
    def weights():
        return (_i8(gen, (9 * C, C), -8, 7, dev),
                (_f(gen, (C,), dev, 2e-5, 2e-4).abs(), _f(gen, (C,), dev, 0.1)))

    (g1, sb1), (g2, sb2) = weights(), weights()
    q1, q2 = _quant(dev, C, 8, -1.0, 4.0), _quant(dev, C, 8, -0.5, 3.0)
    r = _f(gen, (B, H, H, C), dev, 1.5, 0.2).to(torch.bfloat16)
    return (r, _f(gen, (B, C), dev), _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev, 0.1), q1[:2], g1, sb1,
            _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev, 0.1), q2[:2], g2, sb2)


@pytest.mark.parametrize("H,C", [(32, 128), (16, 256), (8, 512), (4, 256)])
def test_k12_kernel_matches_plain(dev, gen, H, C):
    args = _k12_args(gen, dev, 3, H, C)
    before = resblock_pallas.launches
    got = resblock_pallas(*args)
    assert resblock_pallas.launches == before + 1
    fig = checks.compare("K12", got, resblock_pallas(*args, plain=True))
    assert fig["ok"], fig


def test_k12_raises_off_its_types(dev, gen):
    args = list(_k12_args(gen, dev, 1, 4, 128))
    args[0] = args[0].float()
    with pytest.raises(NotImplementedError):
        resblock_pallas(*args)


def test_entry_points_default_to_the_card(dev):
    """`device=None` is the CUDA device: nothing lands on the CPU unasked."""
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.quant.state import from_jax_qstates

    tree = from_jax_params({"conv_in": {"kernel": np.zeros((3, 3, 3, 8), np.float32)}})
    assert tree["conv_in"]["kernel"].device.type == "cuda"
    assert DiffusionSchedule.create("linear", 1e-4, 0.02, 10).betas.device.type == "cuda"
    fields = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")
    qs = from_jax_qstates({"c": {k: np.zeros((1, 2), np.float32) for k in fields}})
    assert qs["c"].act_min.device.type == "cuda"


LEVERS = [dict(), dict(entry_pallas=True), dict(boundary_fusion=True), dict(resblock_pallas="all"),
          dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")]
LEVER_TOY = dict(ch=128, ch_mult=(1, 2, 2), num_res_blocks=2, attn_resolutions=(8,), resolution=16, dropout=0.0)


@pytest.mark.parametrize("levers", LEVERS, ids=lambda kw: "+".join(kw) or "off")
@pytest.mark.parametrize("toy", ["cifar", "church", "levers"])
def test_serving_step_kernels_match_plain(dev, gen, toy, levers):
    """One int8 serving forward of a toy UNet, every kernel call checked
    against its plain version on the same inputs (teacher-forced), with the
    launch counts `checks.expected_launches` derives from the config and
    the levers; the church-shaped toy runs K6 at 128^2 and K3 at C = 512,
    the two-block toy has boundaries for K7 and identity blocks for K12."""
    cfg = UNetConfig(**{"cifar": TOY, "church": CHURCH_TOY, "levers": LEVER_TOY}[toy])
    B, R = 2, cfg.resolution
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, dev)
    for st in qstates.values():  # ranges as calibration leaves them: [-1, 4] per group
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    runtime = prepare_serving_runtime(q, params, qstates)
    x = _f(gen, (B, R, R, 3), dev)
    t = torch.full((B,), 500.0, device=dev)
    checks.reset_launches()
    records = []
    with checks.per_site(records):
        eps = serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0, **levers)
    assert checks.read_launches() == checks.expected_launches(cfg, 1, B, **levers)
    assert torch.isfinite(eps).all()
    bad = [r for r in records if not r[2]["ok"]]
    assert not bad, bad
    if toy == "church" and not levers:
        assert {r[0] for r in records} == {"K1", "K2", "K6", "K3"}
    if toy == "levers" and len(levers) == 3:
        assert {"K4", "K7", "K12"} <= {r[0] for r in records}
