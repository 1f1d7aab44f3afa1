"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `gpu`: every test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is missing
(tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The GroupNorm and attention sums accumulate in float64 in the kernels and
in the plain versions alike, so every comparison here is exact."""
import pytest
import torch

from attentiondm_tpu_torch.models.unet import UNetConfig, unet_init
from attentiondm_tpu_torch.ops.fused_gn import epilogue_gn_swish_quant
from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
from attentiondm_tpu_torch.ops.pallas_conv import int8_conv
from attentiondm_tpu_torch.quant.int8_serving import prepare_serving_runtime, serving_unet_apply
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

pytestmark = pytest.mark.gpu

TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)


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


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("HW,N", [(1024, 128), (16, 256)])
def test_k2_kernel_matches_plain(dev, gen, HW, N, x_dtype):
    B, H = 4, int(HW ** 0.5)
    if x_dtype == torch.int32:
        dot = torch.randint(-20000, 20000, (B, H, H, N), generator=gen, dtype=torch.int32).to(dev)
        inv_ws, zcbias = _f(gen, (N,), dev, 2e-5, 1e-4).abs(), _f(gen, (N,), dev)
    else:
        dot = _f(gen, (B, H, H, N), dev, 1.5, 0.2).to(torch.bfloat16)
        inv_ws, zcbias = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    args = (dot, inv_ws, zcbias, _f(gen, (B, N), dev), _f(gen, (N,), dev, 0.1, 1.0), _f(gen, (N,), dev, 0.1),
            torch.full((N,), 255 / 4.0, device=dev), torch.full((N,), -4.0, device=dev), 8)
    before = epilogue_gn_swish_quant.launches
    got = epilogue_gn_swish_quant(*args)
    assert epilogue_gn_swish_quant.launches == before + 1
    assert torch.equal(got, epilogue_gn_swish_quant(*args, plain=True))


@pytest.mark.parametrize("L,C", [(256, 256), (16, 256), (64, 128)])
def test_k3_kernel_matches_plain(dev, gen, L, C):
    x = _f(gen, (4, L, C), dev, 2.0, 0.3).to(torch.bfloat16)

    def quant(a_bit, r):
        return (torch.full((C,), (2 ** a_bit - 1) / (2 * r), device=dev), torch.zeros(C, device=dev), a_bit)

    def weights():
        return _i8(gen, (C, C), -8, 7, dev), _f(gen, (C,), dev, 5e-5, 2e-4).abs(), _f(gen, (C,), dev, 0.1)

    args = (x, _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev, 0.1), [quant(8, 4), quant(6, 4), quant(8, 4)],
            [weights() for _ in range(3)], quant(8, 3), weights())
    before = fused_attention_block.launches
    got = fused_attention_block(*args, scale=C ** -0.5)
    assert fused_attention_block.launches == before + 1
    assert torch.equal(got, fused_attention_block(*args, scale=C ** -0.5, plain=True))


def test_serving_step_kernels_match_plain(dev, gen):
    """One int8 serving forward of a toy UNet through the kernels equals the
    same forward through the plain versions, with one launch per kernel
    call site."""
    cfg = UNetConfig(**TOY)
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, dev)
    for st in qstates.values():  # ranges as calibration leaves them: [-1, 4] per group
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    runtime = prepare_serving_runtime(q, params, qstates)
    x = _f(gen, (4, 8, 8, 3), dev)
    t = torch.full((4,), 500.0, device=dev)
    counts = (int8_conv.launches, epilogue_gn_swish_quant.launches, fused_attention_block.launches)
    eps = serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0)
    counts = tuple(after - b for after, b in zip(
        (int8_conv.launches, epilogue_gn_swish_quant.launches, fused_attention_block.launches), counts))
    # toy UNet: 8 resblocks (two 3x3 convs each, 5 with a 1x1 shortcut), the
    # downsample, the upsample and conv_out; 4 attention blocks
    assert counts == (8 * 2 + 5 + 3, 8, 4)
    assert torch.isfinite(eps).all()
    assert torch.equal(eps, serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0, plain=True))
