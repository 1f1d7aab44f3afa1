"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `gpu`: every test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is missing
(tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Each kernel is held to its tolerance against its plain version
(`attentiondm_tpu_torch.ops.checks`): K1 exact (int32) or within 1 bf16 ulp,
K2, K6 and K4 at most 1 int8 LSB on at most 0.1% of the codes, K3 (both
cores) mean relative error < 1e-3 with 99% of the elements within 1 bf16
ulp, K7 within 1 bf16 ulp with sums within 1e-6 relative, K12 mean relative
error < 1e-3 with 99.9% within 1 bf16 ulp, K8 and K9 at most 1 LSB on at
most 0.2% of the codes, K10 on at most 1%, K11 within 2e-5 + 2e-5 |x|."""
import os

import pytest
import torch

import numpy as np

from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_init
from attentiondm_tpu_torch.ops import checks, fused_gn
from attentiondm_tpu_torch.ops.fused_gn import (
    epilogue_gn_swish_quant,
    epilogue_gn_swish_quant_blocked,
    epilogue_gn_swish_quant_whole,
    epilogue_residual_gn_stats,
    gn_act_quant,
)
from attentiondm_tpu_torch.ops.attention import flash_attention, spatial_attention
from attentiondm_tpu_torch.ops.int8_attention import (
    attention_core,
    fused_attention_block,
    fused_int8_attention,
    fused_int8_attention_static,
    int8_flash_attention_static,
)
from attentiondm_tpu_torch.ops.pallas_conv import int8_conv, k_major
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


# (B, H, W, Cp, Np, ksize, stride): K = 9216 (church's deepest concat), Wo = 256 (a tile is part of a row), the 4x4
# and 8x8 maps (a tile spans images), odd sizes and ragged edges, stride 2 at even and odd Hp, the flat 1x1 GEMM
K1_SHAPES = [(2, 16, 16, 1024, 128, 3, 1), (3, 4, 256, 128, 128, 3, 1), (2, 4, 4, 256, 256, 3, 1),
             (3, 4, 4, 128, 128, 3, 1), (37, 4, 4, 128, 256, 3, 1), (3, 8, 8, 128, 128, 3, 1),
             (19, 8, 8, 256, 128, 1, 1), (3, 14, 14, 128, 128, 3, 1), (2, 5, 37, 128, 128, 3, 1),
             (3, 16, 16, 128, 128, 3, 2), (2, 15, 15, 256, 128, 3, 2), (3, 7, 12, 128, 256, 3, 2),
             (3, 1, 50, 384, 128, 1, 1), (2, 32, 32, 128, 384, 3, 1)]


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,Cp,Np,ksize,stride", K1_SHAPES)
def test_k1_core_matches_plain(dev, gen, B, H, W, Cp, Np, ksize, stride, out_dtype):
    """The wgmma core against `int8_conv_ref`: int32 out to the bit, bf16 out
    within 1 ulp, with the weights in either layout."""
    Hp, Wp = (H + 2, W + 2) if ksize == 3 and stride == 1 else (H + 1, W + 1) if ksize == 3 else (H, W)
    xp = _i8(gen, (B, Hp, Wp, Cp), -128, 127, dev)
    gq = _i8(gen, (ksize * ksize * Cp, Np), -8, 7, dev)
    inv_ws, zcbias = _f(gen, (Np,), dev, 1e-4, 5e-4).abs(), _f(gen, (Np,), dev)
    kw = dict(ksize=ksize, stride=stride, out_dtype=out_dtype)
    want = int8_conv(xp, gq, inv_ws, zcbias, **kw, plain=True)
    before = int8_conv.launches
    got = int8_conv(xp, gq, inv_ws, zcbias, **kw)
    got_t = int8_conv(xp, None, inv_ws, zcbias, **kw, gqt=k_major(gq))
    assert int8_conv.launches == before + 2
    assert got.shape == want.shape and torch.equal(got, got_t)
    fig = checks.compare("K1", got, want)
    assert fig["ok"], fig
    if out_dtype == torch.int32:
        assert torch.equal(got, want)


def _epilogue_args(gen, dev, B, H, N, x_dtype):
    if x_dtype == torch.int32:
        dot = torch.randint(-20000, 20000, (B, H, H, N), generator=gen, dtype=torch.int32).to(dev)
        inv_ws, zcbias = _f(gen, (N,), dev, 2e-5, 1e-4).abs(), _f(gen, (N,), dev)
    else:
        dot = _f(gen, (B, H, H, N), dev, 1.5, 0.2).to(torch.bfloat16)
        inv_ws, zcbias = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    return (dot, inv_ws, zcbias, _f(gen, (B, N), dev), _f(gen, (N,), dev, 0.1, 1.0), _f(gen, (N,), dev, 0.1),
            torch.full((N,), 255 / 4.0, device=dev), torch.full((N,), -4.0, device=dev), 8)


# every (HW, N) that a serving step of CIFAR-10, LSUN church or celeba-wide gives K2, and K2 called directly at
# K6's 256^2 shape (chunk mode, three levels of sums)
K2_PATH_SHAPES = [(16, 256), (64, 256), (256, 256), (1024, 128), (64, 512), (256, 512), (1024, 256), (4096, 256),
                  (16, 512), (4096, 128), (65536, 128)]


def _offset_group(args):
    """One channel group at a large offset (mean 40): E[x^2] - mu^2 cancels there."""
    args = list(args)
    args[2] = args[2].clone()
    args[2][:args[0].shape[-1] // 32] += 40.0
    return args


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("HW,N", K2_PATH_SHAPES)
def test_k2_kernel_matches_plain(dev, gen, HW, N, x_dtype):
    """K2 at every path shape through the router, and called directly at
    K6's 256^2 shape and wherever int32 input is over the router's budget
    (where the path takes K6; the smoke times the two there): the same bits
    as the plain version, one launch a call."""
    args = _offset_group(_epilogue_args(gen, dev, 2, int(HW ** 0.5), N, x_dtype))
    routed = fused_gn.epilogue_route(args[0].shape, x_dtype) == "K2"
    fn = epilogue_gn_swish_quant if routed else epilogue_gn_swish_quant_whole
    before = epilogue_gn_swish_quant_whole.launches
    got = fn(*args)
    assert epilogue_gn_swish_quant_whole.launches == before + 1
    assert torch.equal(got, fn(*args, plain=True))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
def test_k2_takes_off_grid_shapes_over_the_budget(dev, gen, x_dtype):
    """105 x 105 (HW % 8 = 1) at N = 256, over the whole-image budget and
    off K6's grid, where JAX runs its XLA reference: the router takes K2,
    one launch, the plain version's bits."""
    args = _offset_group(_epilogue_args(gen, dev, 2, 105, 256, x_dtype))
    assert fused_gn.epilogue_route(args[0].shape, x_dtype) == "K2"
    before = epilogue_gn_swish_quant_whole.launches
    got = epilogue_gn_swish_quant(*args)
    assert epilogue_gn_swish_quant_whole.launches == before + 1
    assert torch.equal(got, epilogue_gn_swish_quant(*args, plain=True))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("H", [256, 128])
def test_k6_kernel_matches_plain(dev, gen, H, x_dtype):
    """K6 at the church shapes (N = 128), one channel group at a large
    offset: the same bits as the plain version, one launch a call."""
    args = _offset_group(_epilogue_args(gen, dev, 2, H, 128, x_dtype))
    before = (epilogue_gn_swish_quant_whole.launches, epilogue_gn_swish_quant_blocked.launches)
    got = epilogue_gn_swish_quant(*args)
    assert (epilogue_gn_swish_quant_whole.launches, epilogue_gn_swish_quant_blocked.launches) == (before[0], before[1] + 1)
    assert torch.equal(got, epilogue_gn_swish_quant_blocked(*args, plain=True))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("H,N,kind", [(64, 256, "K2"), (256, 128, "K6")])
def test_epilogue_at_church_batch(dev, gen, H, N, kind, x_dtype):
    """Church's batch of 32 at its largest K2 and K6 shapes (the plans the
    serving path launches there for bf16): bit-equal to the plain versions."""
    args = _offset_group(_epilogue_args(gen, dev, 32, H, N, x_dtype))
    fn = epilogue_gn_swish_quant_whole if kind == "K2" else epilogue_gn_swish_quant_blocked
    assert torch.equal(fn(*args), fn(*args, plain=True))


# (B, HW, N): a 32-window image, a ragged 40 x 40 map (50 windows, the last a part), 2048 windows in three levels
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("B,HW,N", [(3, 1024, 128), (2, 1600, 256), (1, 65536, 128), (2, 64, 1024)])
def test_k2_every_plan_matches_plain(dev, gen, monkeypatch, B, HW, N, x_dtype):
    """K2 under every plan `k2_plans` offers at the shape (each cluster size,
    the slab held and re-read, window and chunk mode), not only the one
    `epilogue_plan` picks: the same bits as the plain version each time."""
    args = _offset_group(_epilogue_args(gen, dev, B, int(HW ** 0.5), N, x_dtype))
    want = epilogue_gn_swish_quant_whole(*args, plain=True)
    plans = fused_gn.k2_plans(HW, N, 2 if x_dtype == torch.bfloat16 else 4)
    assert plans
    for plan in plans:
        monkeypatch.setattr(fused_gn, "epilogue_plan", lambda *a, plan=plan: plan)
        assert torch.equal(epilogue_gn_swish_quant_whole(*args), want), plan


def test_epilogue_plan_refused_by_the_launcher(dev, gen, monkeypatch):
    """A plan other than the launcher's own (shared memory off its layout)
    is refused with an error, not launched."""
    args = _epilogue_args(gen, dev, 2, 32, 128, torch.bfloat16)
    plan = dict(fused_gn.epilogue_plan(2, 1024, 128, torch.bfloat16, "K2"))
    plan["smem"] += 16
    monkeypatch.setattr(fused_gn, "epilogue_plan", lambda *a: plan)
    with pytest.raises(RuntimeError):
        epilogue_gn_swish_quant_whole(*args)


def test_k6_raises_off_its_grid(dev):
    """Over the whole-image budget, N off the 128 grid: JAX's XLA reference
    shape.  The router sends it to K2 (one launch, the plain version's bits);
    K6 called directly raises instead of falling back."""
    N = 96
    dot = torch.zeros((1, 128, 128, N), dtype=torch.bfloat16, device=dev)
    v = torch.ones(N, device=dev)
    args = (dot, v, v, torch.zeros((1, N), device=dev), v, v, v, v, 8)
    assert fused_gn.epilogue_route(dot.shape, dot.dtype) == "K2"
    before = epilogue_gn_swish_quant_whole.launches
    assert torch.equal(epilogue_gn_swish_quant(*args), epilogue_gn_swish_quant(*args, plain=True))
    assert epilogue_gn_swish_quant_whole.launches == before + 1
    with pytest.raises(NotImplementedError):
        epilogue_gn_swish_quant_blocked(*args)


def _k3_args(gen, dev, B, L, C):
    x = _f(gen, (B, L, C), dev, 2.0, 0.3).to(torch.bfloat16)

    def quant(a_bit, r):
        return (torch.full((C,), (2 ** a_bit - 1) / (2 * r), device=dev), torch.zeros(C, device=dev), a_bit)

    def weights():
        return _i8(gen, (C, C), -8, 7, dev), _f(gen, (C,), dev, 5e-5, 2e-4).abs(), _f(gen, (C,), dev, 0.1)

    return (x, _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev, 0.1), [quant(8, 4), quant(6, 4), quant(8, 4)],
            [weights() for _ in range(3)], quant(8, 3), weights())


@pytest.mark.parametrize("L,C", [(256, 256), (16, 256), (64, 128), (256, 512), (64, 512), (64, 1024)])
def test_k3_kernel_matches_plain(dev, gen, L, C):
    args = _k3_args(gen, dev, 4, L, C)
    before = fused_attention_block.launches
    got = fused_attention_block(*args, scale=C ** -0.5)
    assert fused_attention_block.launches == before + 1
    fig = checks.compare("K3", got, fused_attention_block(*args, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(2, 256, 256), (3, 16, 512), (3, 72, 128)])
def test_k3_projections_take_kmajor_weights(dev, gen, B, L, C):
    """K3's four GEMMs (the f32 and the residual-add epilogues of the wgmma
    core) with the weights' K-major copies handed in, as the serving path
    does: the same bits as with the fold layout alone."""
    args = list(_k3_args(gen, dev, B, L, C))
    got = fused_attention_block(*args, scale=C ** -0.5)
    args[4] = [(*w, k_major(w[0])) for w in args[4]]
    args[6] = (*args[6], k_major(args[6][0]))
    assert torch.equal(got, fused_attention_block(*args, scale=C ** -0.5))
    fig = checks.compare("K3", got, fused_attention_block(*args, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("L,C", [(256, 256), (16, 512), (64, 128)])
def test_k3_int8_core_matches_plain(dev, gen, L, C):
    """K3 with the int8 core at the celeba-wide shapes (16^2 x 256, the 4^2 x
    512 mid block) and a small one, at a batch that divides nothing."""
    args = _k3_args(gen, dev, 3, L, C)
    before = (fused_attention_block.launches, fused_attention_block.int8_core_launches)
    got = fused_attention_block(*args, scale=C ** -0.5, int8_core=True)
    assert (fused_attention_block.launches, fused_attention_block.int8_core_launches) == (before[0] + 1, before[1] + 1)
    want = fused_attention_block(*args, scale=C ** -0.5, int8_core=True, plain=True)
    fig = checks.compare("K3", got, want)
    assert fig["ok"], fig
    assert not torch.equal(want, fused_attention_block(*args, scale=C ** -0.5, plain=True))  # the mode is not a no-op


@pytest.mark.parametrize("int8_core", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("C", [128, 256, 512, 1024])
@pytest.mark.parametrize("L", [16, 64, 256, 1024])
def test_k3_tensor_core_cores_match_plain(dev, gen, L, C, B, int8_core):
    """K3's redesigned core (3xTF32 f32 mode; s8 logits in the int8 mode) at
    every width (C = 1024: imagenet64's 8^2 block), from a map shorter than a
    key tile to the longest K3 takes (L = 1024: 32 queries a block), at batch
    1 and 3."""
    args = _k3_args(gen, dev, B, L, C)
    before = fused_attention_block.launches
    got = fused_attention_block(*args, scale=C ** -0.5, int8_core=int8_core)
    assert fused_attention_block.launches == before + 1
    fig = checks.compare("K3", got, fused_attention_block(*args, scale=C ** -0.5, int8_core=int8_core, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(3, 256, 256), (1, 1024, 512), (2, 72, 128), (3, 16, 512), (1, 576, 256),
                                   (2, 64, 1024)])
def test_k3_int8_core_logits_are_exact(dev, gen, B, L, C):
    """The int8 mode's logits (s8 mma) equal float(q8 . k8) * ls of the plain
    version to the bit, and the core's codes meet K3.core's tolerance."""
    q, k, v = (_f(gen, (B, L, C), dev, 1.5) for _ in range(3))
    so, zo = _core_out_quant(dev, C)
    before = attention_core.launches
    got, lg = attention_core(q, k, v, so, zo, 8, scale=C ** -0.5, int8_core=True, logits=True)
    assert attention_core.launches == before + 1
    want, lg_want = attention_core(q, k, v, so, zo, 8, scale=C ** -0.5, int8_core=True, logits=True, plain=True)
    assert torch.equal(lg, lg_want)
    fig = checks.compare("K3.core", got, want)
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(128, 256, 256), (32, 64, 512), (3, 1024, 128), (2, 100, 256), (32, 64, 1024)])
def test_k3_f32_core_alone_matches_plain(dev, gen, B, L, C):
    """K3's f32 core through its own entry point: proj_out's input codes
    within K3.core's tolerance (CIFAR's and church's shapes among them)."""
    q, k, v = (_f(gen, (B, L, C), dev) for _ in range(3))
    so, zo = _core_out_quant(dev, C)
    got = attention_core(q, k, v, so, zo, 8, scale=C ** -0.5)
    fig = checks.compare("K3.core", got, attention_core(q, k, v, so, zo, 8, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


def _core_out_quant(dev, C):
    return torch.full((C,), 255 / 4.0, device=dev), _f(torch.Generator().manual_seed(1), (C,), dev, 3.0).round()


def _static_args(gen, dev, B, L, C):
    """int8 q, k, v and scalar scales that give logits a spread of a few units."""
    q8, k8, v8 = (_i8(gen, (B, L, C), -127, 127, dev) for _ in range(3))
    s = torch.tensor(0.019, device=dev)  # absmax 2.4 / 127: logits of std 127^2 / 3 * s * 1.1 s, about 2
    return (q8, k8, v8, s, s * 1.1, torch.tensor(0.02, device=dev), *_core_out_quant(dev, C), 8)


@pytest.mark.parametrize("B,L,C", [(3, 1024, 256), (2, 2048, 128), (5, 128, 128), (2, 256, 512)])
def test_k9_kernel_matches_plain(dev, gen, B, L, C):
    args = _static_args(gen, dev, B, L, C)
    before = fused_int8_attention_static.launches
    got = fused_int8_attention_static(*args, scale=C ** -0.5)
    assert fused_int8_attention_static.launches == before + 1
    fig = checks.compare("K9", got, fused_int8_attention_static(*args, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(2, 4096, 128), (1, 2304, 128), (3, 1024, 512), (3, 2048, 256)])
def test_k10_kernel_matches_plain(dev, gen, B, L, C):
    """K10 through the static dispatcher (every shape here is over JAX's
    6 MiB budget): the celeba-wide shape, L = 2304 (key blocks snap to 256)
    and the other widths."""
    args = _static_args(gen, dev, B, L, C)
    before = (int8_flash_attention_static.launches, fused_int8_attention_static.launches)
    got = fused_int8_attention_static(*args, scale=C ** -0.5)
    assert (int8_flash_attention_static.launches, fused_int8_attention_static.launches) == (before[0] + 1, before[1])
    fig = checks.compare("K10", got, fused_int8_attention_static(*args, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(3, 1024, 256), (2, 4096, 128), (5, 128, 128), (2, 256, 512), (3, 64, 128)])
def test_k8_kernel_matches_plain(dev, gen, B, L, C):
    """K8 at the celeba-wide shapes (32^2 x 256, 64^2 x 128), the third width
    and maps shorter than JAX's kernel took."""
    dots = [torch.randint(-20000, 20000, (B, L, C), generator=gen, dtype=torch.int32).to(dev) for _ in range(3)]
    epis = [(_f(gen, (C,), dev, 2e-5, 1e-4).abs(), _f(gen, (C,), dev, 0.2)) for _ in range(3)]
    args = (*dots, *epis, *_core_out_quant(dev, C), 8)
    before = fused_int8_attention.launches
    got = fused_int8_attention(*args, scale=C ** -0.5)
    assert fused_int8_attention.launches == before + 1
    fig = checks.compare("K8", got, fused_int8_attention(*args, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(1, 512, 512), (1, 64, 512), (1, 1024, 256), (1, 4096, 128), (3, 192, 512)])
def test_int8_cores_at_c512_and_batch_1(dev, gen, B, L, C):
    """The redesigned K8 / K9 core at C = 512 (four warpgroups split a row
    group's keys and channels, 2 stages, 227 KB of shared memory), at batch 1
    and with a partial last query block of the C = 128 layout."""
    args = _static_args(gen, dev, B, L, C)
    got = fused_int8_attention_static(*args, scale=C ** -0.5)
    kind = "K10" if L * C * 24 > 6 * 1024 * 1024 and L % 256 == 0 else "K9"
    fig = checks.compare(kind, got, fused_int8_attention_static(*args, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig
    dots = [torch.randint(-20000, 20000, (B, L, C), generator=gen, dtype=torch.int32).to(dev) for _ in range(3)]
    epis = [(_f(gen, (C,), dev, 2e-5, 1e-4).abs(), _f(gen, (C,), dev, 0.2)) for _ in range(3)]
    dargs = (*dots, *epis, *_core_out_quant(dev, C), 8)
    fig = checks.compare("K8", fused_int8_attention(*dargs, scale=C ** -0.5),
                         fused_int8_attention(*dargs, scale=C ** -0.5, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(1, 256, 512), (2, 512, 128), (1, 512, 512), (3, 256, 256)])
def test_k10_single_key_block(dev, gen, B, L, C):
    """K10 with one key block (bk = L): the online softmax's first and last
    block are one."""
    args = _static_args(gen, dev, B, L, C)
    q8, k8, v8, sq, sk, sv, osc, ozp, a_bit = args
    scalars = torch.stack([sq, sk, sv])
    before = int8_flash_attention_static.launches
    got = int8_flash_attention_static(q8, k8, v8, scalars, osc, ozp, a_bit, scale=C ** -0.5)
    assert int8_flash_attention_static.launches == before + 1
    want = int8_flash_attention_static(q8, k8, v8, scalars, osc, ozp, a_bit, scale=C ** -0.5, plain=True)
    fig = checks.compare("K10", got, want)
    assert fig["ok"], fig


def test_sampler_refuses_off_width_attention_before_step_0(dev, gen):
    """A config whose attention sites the CUDA kernels do not take (K3 at C =
    384) stops in `sample(x)` before any kernel launches, naming the site."""
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg = UNetConfig(ch=128, ch_mult=(1, 3), num_res_blocks=1, attn_resolutions=(4,), resolution=8, dropout=0.0)
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, dev)
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=dev).betas
    sample = serving_ddim_sampler(q, params, qstates, [0], betas, residual_dtype=torch.bfloat16)
    checks.reset_launches()
    with pytest.raises(NotImplementedError, match=r"mid\.attn_1 \(L=16, C=384\) -> K3"):
        sample(_f(gen, (1, 8, 8, 3), dev))
    assert not any(checks.read_launches().values())


def test_sampler_refuses_off_width_flash_attention_before_step_0(dev, gen):
    """With the f32 core, attention at 32x32 and C = 512 is composed (over
    K3's budget) and reaches K11, which takes heads of 128 or 256: `sample(x)`
    stops before any kernel launches, naming the sites."""
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg = UNetConfig(ch=128, ch_mult=(1, 4), num_res_blocks=1, attn_resolutions=(32,), resolution=64, dropout=0.0)
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, dev)
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=dev).betas
    sample = serving_ddim_sampler(q, params, qstates, [0], betas, residual_dtype=torch.bfloat16, attn_int8=False)
    checks.reset_launches()
    with pytest.raises(NotImplementedError, match=r"down\.1\.attn\.0 \(L=1024, C=512\) -> K11, mid\.attn_1"):
        sample(_f(gen, (1, 64, 64, 3), dev))
    assert not any(checks.read_launches().values())


@pytest.mark.parametrize("L,C", [(72, 128), (256, 384)])
def test_composed_cores_raise_off_their_shapes(dev, gen, L, C):
    """On the card a core launches or raises: no shape gives way to the plain
    version."""
    before = (fused_int8_attention_static.launches, fused_int8_attention.launches)
    with pytest.raises(NotImplementedError):
        fused_int8_attention_static(*_static_args(gen, dev, 2, L, C), scale=C ** -0.5)
    dots = [torch.zeros((2, L, C), dtype=torch.int32, device=dev) for _ in range(3)]
    epis = [(torch.ones(C, device=dev), torch.zeros(C, device=dev)) for _ in range(3)]
    with pytest.raises(NotImplementedError):
        fused_int8_attention(*dots, *epis, *_core_out_quant(dev, C), 8, scale=C ** -0.5)
    assert (fused_int8_attention_static.launches, fused_int8_attention.launches) == before


@pytest.mark.parametrize("B,L,D,block_k", [(2, 4096, 128, 512), (3, 1024, 256, 512), (3, 512, 128, 256),
                                           (1, 1024, 128, 512), (40, 1024, 128, 512), (3, 64, 256, 512),
                                           (3, 1024, 256, 256), (2, 768, 256, 256), (2, 1536, 256, 512),
                                           (2, 1536, 256, 256), (1, 1024, 256, 512)])
def test_k11_kernel_matches_plain(dev, gen, B, L, D, block_k):
    """K11 at the celeba-wide shapes, with 256-key blocks, at a batch that
    takes 128-query blocks (D = 128), at D = 256 with L = 64, 1024 and
    multiples of 64 that are no power of two, and with logits large enough
    that a softmax without the running maximum would overflow."""
    q, k, v = (_f(gen, (B, L, D), dev) for _ in range(3))
    if B == 1:
        q, k = q * 0 + 30.0, k * 0 + 30.0
    before = flash_attention.launches
    got = flash_attention(q, k, v, block_k=block_k)
    assert flash_attention.launches == before + 1 and torch.isfinite(got).all()
    fig = checks.compare("K11", got, flash_attention(q, k, v, block_k=block_k, plain=True))
    assert fig["ok"], fig
    if block_k == 512 and L >= 1024:
        assert torch.equal(got, spatial_attention(q, k, v))


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


# every (B, HW, C) K4 takes in a CIFAR-10 (batch 128), church or imagenet64 (batch 32) serving step with the
# three levers
K4_PATH = [(128, HW, C) for HW, C in [(1024, 128), (256, 128), (64, 256), (16, 256), (16, 512), (64, 512),
                                       (256, 512), (256, 384), (1024, 384), (1024, 256)]]
K4_PATH += [(32, HW, C) for HW, C in [(4096, 128), (1024, 256), (256, 256), (64, 512), (64, 1024), (256, 1024),
                                       (256, 768), (1024, 768), (1024, 512)]]
# and those imagenet64's (batch 32) adds: the decoder's entries past 1024 channels, its 32^2 entries
K4_PATH += [(32, HW, C) for HW, C in [(64, 2048), (64, 1536), (256, 1536), (1024, 128), (1024, 384)]]


def _k4_args(gen, dev, B, HW, C, n_out, x_dtype=torch.bfloat16):
    x = _f(gen, (B, HW, C), dev, 2.0, 0.3)
    x[..., :C // 32] += 40.0
    qp = [_quant(dev, C, b, -1.0, 4.0) for b in (8, 6, 8)[:n_out]]
    return (x.to(x_dtype), _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev, 0.1), qp)


def _bit_equal(got, want):
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("B,HW,C", K4_PATH, ids=str)
def test_k4_path_shapes_bit_equal(dev, gen, B, HW, C):
    """K4 at every serving shape and batch of the two models (bf16, swish,
    one output, in the plan the path launches): the plain version's bits."""
    args = _k4_args(gen, dev, B, HW, C, 1)
    before = gn_act_quant.launches
    got = gn_act_quant(*args)
    assert gn_act_quant.launches == before + 1
    assert _bit_equal(got, gn_act_quant(*args, plain=True))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_out,act", [(1, "none"), (2, "swish"), (3, "none"), (3, "swish")])
@pytest.mark.parametrize("B,HW,C", [(3, 16, 512), (32, 64, 1024), (3, 256, 768), (3, 1024, 384), (2, 4096, 128),
                                    (5, 48, 96)], ids=str)
def test_k4_outputs_and_inputs_bit_equal(dev, gen, B, HW, C, n_out, act, x_dtype):
    """K4 with one to three outputs, swish or none, bf16 or f32 input, in
    both forms (up to 1024 rows: the image form, channel slices at church's
    batch; larger: the cluster form): the plain version's bits."""
    args = _k4_args(gen, dev, B, HW, C, n_out, x_dtype)
    assert _bit_equal(gn_act_quant(*args, act=act), gn_act_quant(*args, act=act, plain=True))


@pytest.mark.parametrize("n_out", [1, 3])
@pytest.mark.parametrize("B,HW,C", [(128, 16, 256), (32, 64, 1024), (32, 256, 768), (128, 1024, 384), (5, 48, 96),
                                    (2, 1600, 256), (32, 64, 2048), (32, 256, 1536), (3, 400, 1152), (3, 4196, 384),
                                    (2, 2048, 1024)], ids=str)
def test_k4_every_plan_bit_equal(dev, gen, monkeypatch, B, HW, C, n_out):
    """K4 under every plan `k4_plans` offers at the shape (each row-group
    count and slicing of the image form, each block size of the blocked
    form, each cluster plan), not only the one `epilogue_plan` picks."""
    args = _k4_args(gen, dev, B, HW, C, n_out)
    want = gn_act_quant(*args, act="none", plain=True)
    plans = fused_gn.k4_plans(B, HW, C, 2, n_out)
    assert plans
    for plan in plans:
        monkeypatch.setattr(fused_gn, "epilogue_plan", lambda *a, plan=plan: plan)
        assert _bit_equal(gn_act_quant(*args, act="none"), want), plan


def test_k4_plan_refused_by_the_launcher(dev, gen, monkeypatch):
    """A plan off the launcher's own (shared memory, or threads over the
    three-output bound) is refused with an error, not launched."""
    args = _k4_args(gen, dev, 2, 16, 256, 3)
    plan = dict(fused_gn.epilogue_plan(2, 16, 256, torch.bfloat16, "K4", 3))
    bad = [{**plan, "smem": plan["smem"] + 16}, {**plan, "threads": 512, "row_groups": 2 * plan["row_groups"]}]
    for p in bad:
        monkeypatch.setattr(fused_gn, "epilogue_plan", lambda *a, p=p: p)
        with pytest.raises(RuntimeError):
            gn_act_quant(*args)


@pytest.mark.parametrize("B,H,C", [(128, 16, 256), (128, 4, 256), (32, 16, 512), (32, 8, 512)])
def test_k12_path_shapes_bit_equal(dev, gen, B, H, C):
    """K12 at the serving shapes and batches of the two models (its GroupNorm
    launches in the image form, channel slices at church's batch, both
    writing their halo'd borders): the plain version's bits."""
    args = _k12_args(gen, dev, B, H, C)
    got = resblock_pallas(*args, g1_t=k_major(args[5]), g2_t=k_major(args[10]))
    assert torch.equal(got, resblock_pallas(*args, plain=True))


@pytest.mark.parametrize("B,H,C", [(3, 16, 256), (2, 8, 512), (2, 64, 128)])
def test_k12_every_plan_bit_equal(dev, gen, monkeypatch, B, H, C):
    """K12 with its two GroupNorm launches under every plan `k4_plans`
    offers for their input types (the image form's row groups and slices,
    the cluster form with the slab held and re-read), each writing the
    halo'd rows and the border: the plain version's bits."""
    args = _k12_args(gen, dev, B, H, C)
    want = resblock_pallas(*args, plain=True)
    plans = {dt: fused_gn.k4_plans(B, H * H, C, size, halo=True)
             for dt, size in ((torch.bfloat16, 2), (torch.int32, 4))}
    for i in range(max(map(len, plans.values()))):
        monkeypatch.setattr(fused_gn, "epilogue_plan", lambda B_, HW, N, dtype, kind, n_out=1, halo=False, i=i:
                            plans[dtype][i % len(plans[dtype])])
        from attentiondm_tpu_torch.ops import pallas_resblock

        monkeypatch.setattr(pallas_resblock, "epilogue_plan", fused_gn.epilogue_plan)
        assert torch.equal(resblock_pallas(*args), want), (plans[torch.bfloat16][i % len(plans[torch.bfloat16])],
                                                            plans[torch.int32][i % len(plans[torch.int32])])


def test_sampler_refuses_gn_sites_before_step_0(dev, gen):
    """A config whose resblock epilogues (1152 channels, past K2's 1024) no
    kernel takes stops in `sample(x)` before any kernel launches, naming the
    site, with `entry_pallas` or without; its decoder concat (2304 channels),
    which no K4 plan takes, is no refused site: that entry runs in plain
    torch."""
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg = UNetConfig(ch=128, ch_mult=(1, 9), num_res_blocks=1, attn_resolutions=(), resolution=8, dropout=0.0)
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, dev)
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=dev).betas
    x = _f(gen, (2, 8, 8, 3), dev)
    checks.reset_launches()
    for levers in (dict(entry_pallas=True), {}):
        with pytest.raises(NotImplementedError, match=r"mid\.block_1 \(HW=16, C=1152\) -> K2/K6") as refused:
            serving_ddim_sampler(q, params, qstates, [0], betas, runtime={}, residual_dtype=torch.bfloat16,
                                 **levers)(x)
        assert "-> K4" not in str(refused.value)
    assert not any(checks.read_launches().values())


@pytest.mark.parametrize("dot_dtype,res_dtype,out_dtype", [
    (torch.bfloat16, torch.float32, torch.bfloat16), (torch.int32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32), (torch.int32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("HW,N", [(1024, 128), (64, 256), (16, 512), (16, 256), (1024, 256), (64, 512),
                                  (2048, 128), (1032, 128)])
def test_k7_kernel_matches_plain(dev, gen, monkeypatch, HW, N, dot_dtype, res_dtype, out_dtype):
    """K7 under its own plan and under every plan `k7_plans` offers, at the
    serving steps' shapes (CIFAR-10's and church's lever steps; bf16 conv2
    output and residual is the serving path's) and past 32 windows: the
    plain version's bits, residual' and sums."""
    B = 3
    if dot_dtype == torch.int32:
        dot = torch.randint(-20000, 20000, (B, HW, N), generator=gen, dtype=torch.int32).to(dev)
        inv_ws, zcbias = _f(gen, (N,), dev, 2e-5, 1e-4).abs(), _f(gen, (N,), dev)
    else:
        dot = _f(gen, (B, HW, N), dev, 1.5, 0.2).to(torch.bfloat16)
        inv_ws, zcbias = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    x_res = _f(gen, (B, HW, N), dev, 2.0, 0.5)
    x_res[..., :N // 32] += 40.0
    x_res = x_res.to(res_dtype)
    before = epilogue_residual_gn_stats.launches
    got = epilogue_residual_gn_stats(dot, inv_ws, zcbias, x_res, out_dtype=out_dtype)
    assert epilogue_residual_gn_stats.launches == before + 1
    assert got[0].dtype == out_dtype and tuple(got[1].shape) == (B, 2, 32)
    want = epilogue_residual_gn_stats(dot, inv_ws, zcbias, x_res, out_dtype=out_dtype, plain=True)
    fig = checks.compare("K7", got, want)
    assert fig["ok"], fig
    for plan in fused_gn.k7_plans(HW, N):
        monkeypatch.setattr(fused_gn, "epilogue_plan", lambda *_a, plan=plan: plan)
        got = epilogue_residual_gn_stats(dot, inv_ws, zcbias, x_res, out_dtype=out_dtype)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), plan


def test_k7_plan_refused_by_the_launcher(dev, gen, monkeypatch):
    """A plan off K7's launcher (shared memory off its layout, threads over
    K7's bound, a slice narrower than a thread's channels, the cluster form,
    more than 32 row groups, channels a thread other than 8, 4, 2 or 1) is
    refused with an error, not launched."""
    B, HW, N = 2, 1024, 256
    dot = _f(gen, (B, HW, N), dev).to(torch.bfloat16)
    args = (dot, torch.ones(N, device=dev), torch.zeros(N, device=dev), _f(gen, (B, HW, N), dev).to(torch.bfloat16))
    plan = next(p for p in fused_gn.k7_plans(HW, N) if (p["vec"], p["row_groups"], p["threads"]) == (8, 32, 128))
    bad = [{**plan, "smem": plan["smem"] + 16}, {**plan, "slices": 2, "threads": 512},
           {**plan, "slices": 64, "threads": 32, "smem": fused_gn._image_smem(32, 4)},
           {**plan, "form": "cluster", "cluster": 2, "wpb": 16, "held": False},
           {**plan, "slices": 32, "threads": 64, "smem": fused_gn._image_smem(32, 8)},
           {**plan, "vec": 3}, {**plan, "vec": 16, "threads": 64}]
    before = epilogue_residual_gn_stats.launches
    for p in bad:
        monkeypatch.setattr(fused_gn, "epilogue_plan", lambda *a, p=p: p)
        with pytest.raises(RuntimeError):
            epilogue_residual_gn_stats(*args, out_dtype=torch.bfloat16)
    assert epilogue_residual_gn_stats.launches == before


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


@pytest.mark.parametrize("B,H,C", [(2, 32, 128), (3, 8, 256), (2, 4, 1024)])
def test_k12_gemms_take_kmajor_folds(dev, gen, B, H, C):
    """K12's two GEMMs (the int32 and the residual-add epilogues of the wgmma
    core, K = 9216 at C = 1024) with the folds' K-major copies handed in."""
    args = _k12_args(gen, dev, B, H, C)
    got = resblock_pallas(*args)
    assert torch.equal(got, resblock_pallas(*args, g1_t=k_major(args[5]), g2_t=k_major(args[10])))
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


ATTN_TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(32, 16), resolution=32, dropout=0.0)
ATTN_FLAGS = {"static": dict(attn_int8=True, attn_ranges=True), "dynamic": dict(attn_int8=True),
              "f32": dict(attn_int8=False)}


@pytest.mark.parametrize("setting", ATTN_FLAGS)
def test_serving_step_attention_cores_match_plain(dev, gen, setting):
    """One serving forward of a toy that attends at 32^2 (L = 1024, C = 128:
    the composed branch, K9 / K8 / K11 by the flags) and 16^2 (L = 256, C =
    256: K3, its int8 core under attn_int8), every kernel call checked against
    its plain version and the launch counts against the plan."""
    cfg = UNetConfig(**ATTN_TOY)
    B, R = 3, cfg.resolution
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, dev)
    for st in qstates.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    runtime = prepare_serving_runtime(q, params, qstates)
    flags = dict(ATTN_FLAGS[setting])
    if flags.get("attn_ranges"):
        flags["attn_ranges"] = {f"{site}.{k}": torch.full((1,), 3.0, device=dev)
                                for site, _L, _C in checks.conv_plan(cfg)[4] for k in ("q", "k", "v")}
    checks.reset_launches()
    records = []
    with checks.per_site(records):
        eps = serving_unet_apply(params, cfg, q, runtime, qstates, _f(gen, (B, R, R, 3), dev),
                                 torch.full((B,), 500.0, device=dev), 0, residual_dtype=torch.bfloat16, **flags)
    counts = checks.read_launches()
    assert counts == checks.expected_launches(cfg, 1, B, **flags)
    core = {"static": "K9", "dynamic": "K8", "f32": "K11"}[setting]
    assert counts[core] == 3 and counts["K3"] == 4 and counts["K3.int8_core"] == (0 if setting == "f32" else 4)
    assert torch.isfinite(eps).all()
    bad = [r for r in records if not r[2]["ok"]]
    assert not bad, bad
    assert core in {r[0] for r in records}


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
        eps = serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0, residual_dtype=torch.bfloat16, attn_int8=False,
                                 **levers)
    assert checks.read_launches() == checks.expected_launches(cfg, 1, B, attn_int8=False, **levers)
    assert torch.isfinite(eps).all()
    bad = [r for r in records if not r[2]["ok"]]
    assert not bad, bad
    if toy == "church" and not levers:
        assert {r[0] for r in records} == {"K1", "K2", "K6", "K3"}
    if toy == "levers" and len(levers) == 3:
        assert {"K4", "K7", "K12"} <= {r[0] for r in records}


def test_fold_forms_equal_the_plain_sampler(dev, gen):
    """On the card, `step_chunk` with micro-batches (uneven ones too),
    `pack_int4` and both give the plain sampler's bits: every kernel sums in
    an order that does not depend on the batch, and a timestep shared by the
    batch takes its time embedding from one row at any batch size."""
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg = UNetConfig(**TOY)
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(4, dev)
    for st in qstates.values():  # ranges as calibration leaves them: [-1, 4] per group
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    betas = DiffusionSchedule.create("cosine", 1e-4, 0.02, 1000, device=dev).betas
    seq, x = [0, 300, 600, 900], _f(gen, (4, 8, 8, 3), dev)
    ref = serving_ddim_sampler(q, params, qstates, seq, betas, residual_dtype=torch.bfloat16, attn_int8=False)(x)
    for kw in (dict(step_chunk=2, micro_batch=2), dict(pack_int4=True),
               dict(step_chunk=3, micro_batch=3, pack_int4=True)):
        out = serving_ddim_sampler(q, params, qstates, seq, betas, residual_dtype=torch.bfloat16, attn_int8=False, **kw)(x)
        assert torch.equal(out, ref), kw


# ---------------------------------------------------------------------------
# the weight extras on the card (quant.adaround, quant.gptq, the fold)
# ---------------------------------------------------------------------------


def _correlated_gram(gen, K, m=4096, rank=16):
    """A normalized Gram of inputs that are low rank plus noise (where rounding decisions matter)."""
    x = torch.randn(m, rank, generator=gen) @ torch.randn(rank, K, generator=gen) + 0.1 * torch.randn(m, K,
                                                                                                   generator=gen)
    return x.T @ x / m


def test_adaround_on_the_card_matches_the_cpu(dev, gen):
    """One full-width CIFAR-10 layer (3x3, 128 -> 128, K = 1152), 200 Adam
    steps on the card and on the CPU: decisions equal on at least 98% of the
    weights, the Gram objective within 1%.  On this low-rank Gram 200 steps
    leave many h near 0.5, where the last bits decide: two CPU runs of the
    same code differ on up to 0.8% of them (the BLAS's sums move with the
    buffers' alignment)."""
    from attentiondm_tpu_torch.quant import adaround as ar

    g = torch.randn(1152, 128, generator=gen) * 0.05
    gram, shrink = _correlated_gram(gen, 1152), torch.ones(128)
    h_cpu = ar._adaround_opt(g, gram, shrink, w_bit=4, symmetric=True, iters=200)
    h_dev = ar._adaround_opt(g.to(dev), gram.to(dev), shrink.to(dev), w_bit=4, symmetric=True, iters=200).cpu()
    assert (h_dev == h_cpu).float().mean() >= 0.98
    kernel = g.reshape(3, 3, 128, 128)
    stats = ar.ConvStats(gram=gram, mu=torch.zeros(1152), count=torch.tensor(1.0))
    e = [float(ar.gram_objective(kernel, torch.ones(128), stats, 4, shrink, h.reshape(kernel.shape).to(torch.int16)))
         for h in (h_cpu, h_dev)]
    assert abs(e[1] - e[0]) <= 0.01 * e[0]


def test_gptq_on_the_card_matches_the_cpu(dev, gen):
    """One full-width CIFAR-10 layer (3x3, 256 -> 256, K = 2304): cuSOLVER's
    Cholesky factors against LAPACK's, the grid values equal on at least 98%
    of the weights (a tie rounds the other way and the compensation carries
    it on), the output-space objective within 2% (measured 1.3% on this
    low-rank Gram, where GPTQ gains little over round-to-nearest)."""
    from attentiondm_tpu_torch.quant import adaround as ar
    from attentiondm_tpu_torch.quant import gptq

    g = torch.randn(2304, 256, generator=gen) * 0.05
    gram, shrink = _correlated_gram(gen, 2304), torch.ones(256)
    q_cpu = gptq._gptq_opt(g, gram, shrink, w_bit=4, symmetric=True)
    q_dev = gptq._gptq_opt(g.to(dev), gram.to(dev), shrink.to(dev), w_bit=4, symmetric=True).cpu()
    assert (q_dev == q_cpu).float().mean() >= 0.98
    kernel = g.reshape(3, 3, 256, 256)
    stats = ar.ConvStats(gram=gram, mu=torch.zeros(2304), count=torch.tensor(1.0))
    e = [float(ar.gram_objective(kernel, torch.ones(256), stats, 4, shrink,
                                 gptq._offsets_of(q[None], g[None], shrink[None], 4, True)[0]
                                 .reshape(kernel.shape).to(torch.int16))) for q in (q_cpu, q_dev)]
    assert abs(e[1] - e[0]) <= 0.02 * e[0]


@pytest.mark.parametrize("rank1", [False, True], ids=["per_step", "rank1"])
def test_fold_with_extras_on_the_card_matches_the_cpu(dev, gen, rank1):
    """`_fold_all_steps` with all five extras at a full-width CIFAR-10 layer
    (3x3, 256 -> 256) and 10 steps: gq equal, ws and zcorr within float
    order."""
    from attentiondm_tpu_torch.quant.int8_runtime import _fold_all_steps

    S, C = 10, 256
    kernel = torch.randn(3, 3, C, C, generator=gen) * 0.03
    gr = torch.stack([-torch.rand(S, 8, generator=gen) * 3 - 0.3, torch.rand(S, 8, generator=gen) * 5 + 0.5], -1)
    al = torch.full((S, 8, C), 0.2)
    extras = dict(round_offset=torch.randint(-1, 3, (3, 3, C, C), generator=gen, dtype=torch.int16),
                  input_mu=torch.randn(9 * C, generator=gen) * 0.1, shrink=torch.full((C,), 0.91),
                  out_mult=1 + 0.05 * torch.randn(C if rank1 else (S, C), generator=gen),
                  bias_delta=0.05 * torch.randn(C if rank1 else (S, C), generator=gen))
    cpu = _fold_all_steps(kernel, gr, al, 8, 4, rank1=rank1, **extras)
    card = _fold_all_steps(kernel.to(dev), gr.to(dev), al.to(dev), 8, 4, rank1=rank1,
                           **{k: v.to(dev) for k, v in extras.items()})
    assert torch.equal(card[0].cpu(), cpu[0])
    for a, b in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the enhanced attention variant, stage 2 and stage 3 on the card
# ---------------------------------------------------------------------------

ENHANCED_TOY = dict(TOY, attn_variant="enhanced")


def _enhanced(gen, dev, steps=1):
    """The enhanced toy with seeded gammas (its init of 0 makes every block the identity), states as
    calibration leaves them, and stage-3 states from `calibrate_mp_attention`'s update at W4A8's base bits."""
    from attentiondm_tpu_torch.quant import attention_mp as mp

    cfg = UNetConfig(**ENHANCED_TOY)
    params = unet_init(gen, cfg, dev)
    for site in ("down.0.attn.0", "mid.attn_1", "up.0.attn.0", "up.0.attn.1"):
        node = params
        for p in site.split("."):
            node = node[int(p)] if isinstance(node, list) else node[p]
        node["gamma"].fill_(0.5 + float(torch.rand(1, generator=gen)))
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(steps, dev)
    for st in qstates.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    mp_states = {site: mp.update_quant_params(mp.init_mp_attention_state(1000, dev), torch.tensor(-6.0, device=dev),
                                              torch.tensor(7.0, device=dev), 4)
                 for site in ("down.0.attn.0", "mid.attn_1", "up.0.attn.0", "up.0.attn.1")}
    return cfg, params, q, qstates, mp_states


@pytest.mark.parametrize("mp_core", [False, True], ids=["f32_core", "mp_core"])
def test_serving_step_enhanced_kernels_match_plain(dev, gen, mp_core):
    """One serving step of the enhanced toy: every kernel call (K1's 1x1
    projections, K2, the 3x3 convs) held to its plain version on the same
    inputs, the launch counts `expected_launches` gives (four K1 1x1
    launches a site, no attention kernel), and the whole step through the
    kernels equal to the bit to the whole step through the plain versions
    (no K3 runs; K1's and K2's outputs equal their plain versions' here)."""
    cfg, params, q, qstates, mp_states = _enhanced(gen, dev)
    runtime = prepare_serving_runtime(q, params, qstates)
    x, t = _f(gen, (2, 8, 8, 3), dev), torch.full((2,), 500.0, device=dev)
    kw = dict(residual_dtype=torch.bfloat16, attn_int8=False)
    if mp_core:
        kw.update(mp_states=mp_states, mp_base_bits=4)
    checks.reset_launches()
    records = []
    with checks.per_site(records):
        eps = serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0, **kw)
    assert checks.read_launches() == checks.expected_launches(cfg, 1, 2, attn_int8=False)
    assert torch.isfinite(eps).all() and {r[0] for r in records} == {"K1", "K2"}
    bad = [r for r in records if not r[2]["ok"]]
    assert not bad, bad
    plain = serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0, plain=True, **kw)
    assert torch.equal(eps, plain)


def test_enhanced_default_sampler_on_the_card(dev, gen):
    """The enhanced sampler with its default `attn_int8` (None: no int8
    core on the enhanced block): the launches `expected_launches` gives at
    the defaults, the bits of the `attn_int8=False` call, and an explicit
    `attn_int8=True` still raises."""
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg, params, q, qstates, _ = _enhanced(gen, dev, steps=2)
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=dev).betas
    x = _f(gen, (2, 8, 8, 3), dev)
    checks.reset_launches()
    out = serving_ddim_sampler(q, params, qstates, [0, 500], betas)(x)
    assert checks.read_launches() == checks.expected_launches(cfg, 2, 2)
    assert torch.isfinite(out).all()
    assert torch.equal(out, serving_ddim_sampler(q, params, qstates, [0, 500], betas, attn_int8=False)(x))
    with pytest.raises(ValueError, match="attn_int8=False or None"):
        serving_ddim_sampler(q, params, qstates, [0, 500], betas, attn_int8=True)


@pytest.mark.parametrize("head_split", ["aligned", "ref"])
@pytest.mark.parametrize("base_bits", [8, 4, 2])
def test_mp_attention_on_the_card_matches_the_cpu(dev, gen, head_split, base_bits):
    """The stage-3 core at the CIFAR-10 enhanced shape (L = 256, Ck = 32,
    C = 256, 8 heads), unquantized, with quantized logits and with quantized
    logits and probabilities: the card's f32 products in another order
    (measured over the six cases at most 1.08e-7 mean relative, 4.8e-7
    largest difference; no logit on a rounding tie of the quantizer)."""
    from attentiondm_tpu_torch.ops.precision import exact_f32
    from attentiondm_tpu_torch.quant import attention_mp as mp

    q, k, v = _f(gen, (4, 256, 32), "cpu", 2.0), _f(gen, (4, 32, 256), "cpu", 2.0), _f(gen, (4, 256, 256), "cpu")
    st = mp.update_quant_params(mp.init_mp_attention_state(1000, "cpu"), torch.tensor(-12.0), torch.tensor(12.0),
                                base_bits)
    st.timestep_importance.copy_(torch.randn(1000, generator=gen))
    kw = dict(num_heads=8, base_bits=base_bits, timestep=torch.tensor(321), head_split=head_split)
    want = mp.mp_attention(q, k, v, st, **kw)
    with exact_f32():
        got = mp.mp_attention(q.to(dev), k.to(dev), v.to(dev), st.to(dev),
                              **{**kw, "timestep": kw["timestep"].to(dev)}).cpu()
    d = (got - want).abs()
    assert (d.mean() / want.abs().mean()).item() < 4.3e-7
    assert d.max().item() < 1.9e-6


def test_stage2_update_on_the_card_matches_the_cpu(dev, gen):
    """`calibrate_differentiable` (one epoch, the attention projections, the
    same noise) on the enhanced toy on the card and on the CPU: the losses
    within 1e-3 relative (measured 6.5e-4: the forwards' float order), the
    trained layers' mixed ranges equal (measured equal)."""
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import map_tree
    from attentiondm_tpu_torch.quant.calibrate import calibrate_differentiable
    from attentiondm_tpu_torch.quant.state import mixed_ranges

    cfg, params, q, qstates, _ = _enhanced(gen, "cpu", steps=2)
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas
    x0, noise = _f(gen, (2, 8, 8, 3), "cpu"), _f(gen, (1, 2, 2, 8, 8, 3), "cpu")
    runs = []
    for d in ("cpu", dev):
        def to(a, d=d):
            return a.to(d)

        runs.append(calibrate_differentiable(q, map_tree(to, params), {k: v.to(d) for k, v in qstates.items()},
                                             to(x0), [0, 500], to(betas), noise=to(noise), attention_focus=True))
    (cpu, l_cpu), (card, l_card) = runs
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-3)
    for name, st in cpu.items():
        if "attn" in name:
            for s in range(2):
                for a, b in zip(mixed_ranges(card[name].to("cpu"), s), mixed_ranges(st, s)):
                    assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the float32 residual stream, dot_bf16=False, the interception runtime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Cp,Np,ksize", [(128, 16, 256, 256, 1), (32, 8, 1024, 1024, 1), (3, 8, 256, 256, 3),
                                             (2, 32, 128, 128, 3), (5, 4, 512, 256, 3)])
def test_k1_resadd_matches_plain(dev, gen, B, H, Cp, Np, ksize, res_dtype):
    """K1's residual-add epilogues (K3's last launch at 1x1, K12's at 3x3):
    res + (acc * inv_ws + zcbias), f32 not rounded (EPI_RESADD_F32) or
    rounded once to bf16, bit-equal to the plain version."""
    xp = _i8(gen, (B, H + 2 if ksize == 3 else H, H + 2 if ksize == 3 else H, Cp), -128, 127, dev)
    gq = _i8(gen, (ksize * ksize * Cp, Np), -8, 7, dev)
    inv_ws, zcbias = _f(gen, (Np,), dev, 1e-4, 5e-4).abs(), _f(gen, (Np,), dev)
    res = _f(gen, (B, H, H, Np), dev, 2.0, 0.3).to(res_dtype)
    kw = dict(ksize=ksize, out_dtype=res_dtype, res=res)
    key = f"{ksize}x{ksize}/s1/resadd_{str(res_dtype).removeprefix('torch.')}"
    before = int8_conv.launches_by_mode.get(key, 0)
    got = int8_conv(xp, gq, inv_ws, zcbias, **kw)
    assert int8_conv.launches_by_mode[key] == before + 1 and got.dtype == res_dtype
    assert torch.equal(got, int8_conv(xp, gq, inv_ws, zcbias, **kw, plain=True))


def _k12_f32_args(gen, dev, B, H, C):
    args = list(_k12_args(gen, dev, B, H, C))
    args[0] = _f(gen, (B, H, H, C), dev, 1.5, 0.2)  # the float32 residual stream
    return args


@pytest.mark.parametrize("B,H,C", [(128, 16, 256), (128, 4, 256), (32, 16, 512), (32, 8, 512), (3, 32, 128),
                                   (2, 4, 1024)])
def test_k12_f32_bit_equal(dev, gen, B, H, C):
    """K12 at a float32 residual (GN1 reads it as it is, conv2's epilogue
    adds it in f32): the plain version's bits, one launch."""
    args = _k12_f32_args(gen, dev, B, H, C)
    before = resblock_pallas.launches
    got = resblock_pallas(*args, out_dtype=torch.float32)
    assert resblock_pallas.launches == before + 1 and got.dtype == torch.float32
    assert torch.equal(got, resblock_pallas(*args, out_dtype=torch.float32, plain=True))
    with pytest.raises(NotImplementedError):  # a float32 residual in and bf16 out is no mode of the chain
        resblock_pallas(*args)


@pytest.mark.parametrize("B,L,C", [(128, 256, 256), (128, 16, 256), (32, 256, 512), (32, 64, 512),
                                   (32, 64, 1024), (3, 72, 128)])
@pytest.mark.parametrize("int8_core", [False, True], ids=["f32_core", "int8_core"])
def test_k3_f32_matches_plain(dev, gen, B, L, C, int8_core):
    """K3 at a float32 residual, at every K3 width (CIFAR's 16^2 and 4^2,
    church's, imagenet64's C = 1024): K3's tolerance, restated for an f32
    output (`checks.compare`), one launch; the residual passes through
    unrounded."""
    args = list(_k3_args(gen, dev, B, L, C))
    args[0] = args[0].float() + _f(gen, (B, L, C), dev, 1e-3)  # values off the bf16 grid
    before = fused_attention_block.launches
    got = fused_attention_block(*args, scale=C ** -0.5, int8_core=int8_core)
    assert fused_attention_block.launches == before + 1 and got.dtype == torch.float32
    fig = checks.compare("K3", got, fused_attention_block(*args, scale=C ** -0.5, int8_core=int8_core, plain=True))
    assert fig["ok"], fig


F32_FLAGS = {"f32": dict(residual_dtype=torch.float32),
             "f32+levers": dict(residual_dtype=torch.float32, entry_pallas=True, boundary_fusion=True,
                                resblock_pallas="all"),
             "int32_dot": dict(residual_dtype=torch.float32, dot_bf16=False),
             "int32_dot+levers": dict(residual_dtype=torch.float32, dot_bf16=False, entry_pallas=True,
                                      boundary_fusion=True, resblock_pallas="all"),
             "bf16_int32_dot": dict(residual_dtype=torch.bfloat16, dot_bf16=False)}
NARROW_TOY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)


@pytest.mark.parametrize("setting", F32_FLAGS)
@pytest.mark.parametrize("toy", ["cifar", "levers", "narrow"])
def test_serving_step_f32_kernels_match_plain(dev, gen, toy, setting):
    """One serving forward at the float32 stream and with dot_bf16=False
    (with and without the levers), every kernel call held against its plain
    version (teacher-forced), the launch counts `expected_launches` gives
    for those flags; the narrow toy's convs off the fold take the unfused
    chain."""
    cfg = UNetConfig(**{"cifar": TOY, "levers": LEVER_TOY, "narrow": NARROW_TOY}[toy])
    B, R = 2, cfg.resolution
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, dev)
    for st in qstates.values():  # ranges as calibration leaves them: [-1, 4] per group
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    runtime = prepare_serving_runtime(q, params, qstates)
    flags = dict(attn_int8=False, **F32_FLAGS[setting])
    checks.reset_launches()
    records = []
    with checks.per_site(records):
        eps = serving_unet_apply(params, cfg, q, runtime, qstates, _f(gen, (B, R, R, 3), dev),
                                 torch.full((B,), 500.0, device=dev), 0, **flags)
    assert checks.read_launches() == checks.expected_launches(cfg, 1, B, **flags)
    assert torch.isfinite(eps).all()
    bad = [r for r in records if not r[2]["ok"]]
    assert not bad, bad
    kinds = {r[0] for r in records}
    if toy == "levers" and "levers" in setting:
        assert ({"K4", "K7", "K12"} if "int32" not in setting else {"K4", "K7"}) <= kinds
    if toy == "narrow":
        assert kinds == {"K1"}


def _interception_model(gen):
    """A toy's params, states and asymmetric interception fold, made on the CPU."""
    from attentiondm_tpu_torch.quant.int8_runtime import prepare_int8_runtime

    cfg = UNetConfig(**TOY)
    params = unet_init(gen, cfg, "cpu")
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(2, "cpu")
    for st in qstates.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
        st.alpha_logits.normal_(generator=gen)
    return cfg, q, params, qstates, prepare_int8_runtime(q, params, qstates, symmetric=False)


def test_int8_model_fn_asymmetric_on_the_card_matches_the_cpu(dev, gen):
    """The interception runtime with asymmetric folds: one forward through
    `int8_model_fn` on the card (K13 / K5 on K1), its launch counts, each
    product held to its plain version, the whole forward equal to the
    card's plain forward (the int32 sums are exact), and within 6.2e-2 of
    the CPU's (measured 1.56e-2: cuDNN's float convs of conv_in and the
    downsample and the card's reductions round in other last bits, which
    flips int8 codes on ties downstream)."""
    from attentiondm_tpu_torch.models.unet import map_tree
    from attentiondm_tpu_torch.quant.int8_runtime import Int8Layer, int8_model_fn
    from attentiondm_tpu_torch.quant.state import ActQuantState

    cfg, q, params, qstates, rt = _interception_model(gen)
    x, t = _f(gen, (2, 8, 8, 3), "cpu"), torch.full((2,), 500.0)
    cpu = int8_model_fn(q, rt, params, qstates, symmetric=False)(x, t, 1)
    to = dict(device=dev)
    params_d = map_tree(lambda a: a.to(**to), params)
    qs_d = {k: ActQuantState(*(getattr(v, f).to(**to) for f in ("init_range", "act_min", "act_max", "group_ranges",
                                                                  "alpha_logits"))) for k, v in qstates.items()}
    rt_d = {k: Int8Layer(None, *(getattr(v, f).to(**to) for f in ("ws", "wzp", "zcorr", "act_scale", "act_zp")),
                         gqt=v.gqt.to(**to)) for k, v in rt.items()}
    checks.reset_launches()
    records = []
    with checks.per_site(records):
        card = int8_model_fn(q, rt_d, params_d, qs_d, symmetric=False)(x.to(**to), t.to(**to), 1)
    assert checks.read_launches() == checks.interception_launches(cfg, 1)
    assert records and all(r[2]["ok"] for r in records) and {r[0] for r in records} == {"K13", "K5"}
    assert torch.equal(card, int8_model_fn(q, rt_d, params_d, qs_d, symmetric=False, plain=True)(
        x.to(**to), t.to(**to), 1))
    rel = ((card.cpu() - cpu).abs().mean() / cpu.abs().mean()).item()
    assert rel < 6.2e-2, rel


@pytest.mark.parametrize("kind", ["ddpm_noisy", "eta"])
def test_runner_serving_sample_on_the_card(dev, tmp_path, kind):
    """The runner's serving `sample()` on the card (the toy UNet at W4A8,
    `--sample_type ddpm_noisy` or `--eta 0.5`): K1, K2 and K3 launched as
    `expected_launches` says for its flags, eight PNGs written, and the
    same sampler through the plain versions on the same generator within
    the chained bound (0.1 mean relative) of the kernels' run."""
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler
    from attentiondm_tpu_torch.runners.diffusion import Diffusion

    args, config = _card_runner(tmp_path, "run", eta=0.5 if kind == "eta" else 0.0,
                                sample_type=kind if kind == "ddpm_noisy" else "generalized")
    r = Diffusion(args, config)
    checks.reset_launches()
    r.sample()
    counts = checks.read_launches()
    srv = r.serving
    flags = {k: srv["kwargs"][k] for k in ("attn_int8", "attn_ranges", "residual_dtype")}
    assert counts == checks.expected_launches(r.ucfg, 3, 8, **flags)
    assert counts["K1"] and counts["K2"] and counts["K3"]
    assert sorted(os.listdir(args.image_folder)) == sorted([f"sample_{i}.png" for i in range(8)] + ["grid.png"])
    x, kw = r.randomness("sample", (8, 8, 8, 3))
    out = srv["sampler"](x, **kw)
    x, kw = r.randomness("sample", (8, 8, 8, 3))
    plain = serving_ddim_sampler(srv["qunet"], srv["params"], srv["qstates"], srv["seq"], r.betas, plain=True,
                                 runtime=srv["sampler"].runtime, **srv["kwargs"])(x, **kw)
    rel = ((out - plain).abs().mean() / plain.abs().mean()).item()
    assert torch.isfinite(out).all() and rel < 0.1, rel


def test_flash_attention_refuses_autograd_on_the_card(dev, gen):
    """K11 has no backward: with grad mode on and an input that requires
    grad it raises on the card as on the CPU; under no_grad it launches."""
    q = _f(gen, (1, 1024, 128), dev).requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        spatial_attention(q, q, q)
    n = flash_attention.launches
    with torch.no_grad():
        out = spatial_attention(q, q, q)
    assert flash_attention.launches == n + 1 and torch.isfinite(out).all()


@pytest.mark.parametrize("optimizer", ["Adam", "RMSProp", "SGD"])
def test_train_step_on_the_card_matches_the_cpu(dev, gen, optimizer):
    """One training step (dropout 0.1, clipping, EMA) on the card against the
    same step on the CPU, given the same params, batch, t, eps and masks:
    the loss within 1e-5 relative, the state by
    `training.compare_train_states` (the CPU tests' tolerances)."""
    import dataclasses

    from attentiondm_tpu_torch.config import dict2namespace
    from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from attentiondm_tpu_torch.models.unet import dropout_shapes, map_tree
    from attentiondm_tpu_torch.training import (
        compare_train_states,
        get_optimizer,
        init_train_state,
        make_train_step,
    )

    cfg = dataclasses.replace(UNetConfig(**TOY), dropout=0.1)
    lr = 2e-4
    tx = get_optimizer(dict2namespace({"optim": dict(optimizer=optimizer, lr=lr, beta1=0.9, eps=1e-8,
                                                     weight_decay=0.0)}))
    params = unet_init(gen, cfg, "cpu")
    x0 = torch.rand((4, 8, 8, 3), generator=gen) * 2 - 1
    t = torch.randint(0, 1000, (4,), generator=gen)
    e = torch.randn(x0.shape, generator=gen)
    masks = [torch.rand(s, generator=gen) < 0.9 for s in dropout_shapes(cfg, 4)]
    states, losses = {}, {}
    for where in ("cpu", dev):
        betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device=where).betas
        step = make_train_step(cfg, betas, tx, grad_clip=1.0, ema_rate=0.9)
        state = init_train_state(map_tree(lambda a: a.to(where), params), tx)
        states[str(where)], losses[str(where)] = step(state, x0.to(where), t=t.to(where), e=e.to(where),
                                                      dropout_masks=[m.to(where) for m in masks])
    got, want = states[str(dev)], states["cpu"]
    assert abs(losses[str(dev)].item() - losses["cpu"].item()) <= 1e-5 * abs(losses["cpu"].item())
    res = compare_train_states(got, want, lr)
    assert res["ok"], res


def test_inception_on_the_card_matches_the_cpu(dev):
    """The seeded random FID Inception on the card (under `exact_f32()`)
    against the same network on the CPU: 4 images at 32^2, max |difference|
    / max |feature| < 1e-4 (the bound the CPU tests hold the port to JAX)."""
    from attentiondm_tpu_torch.eval.inception import InceptionV3FID

    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    got = InceptionV3FID.random(device=dev).extract(x.to(dev)).cpu()
    want = InceptionV3FID.random(device="cpu").extract(x)
    assert torch.isfinite(got).all() and ((got - want).abs().max() / want.abs().max()).item() < 1e-4


def test_sharded_statistics_on_the_card(dev):
    """Float32 sums of f and f f^T on the card against float64 statistics of
    the same features (offset by 1, as Inception's are), within the
    cancellation that JAX's form has at this mean-to-spread ratio."""
    from attentiondm_tpu_torch.eval.fid import sharded_statistics

    f = torch.randn((512, 256), generator=torch.Generator().manual_seed(2), dtype=torch.float64) * 0.1 + 1.0
    mu, sigma = sharded_statistics(f.float().to(dev), lambda b: b, batch_size=128)
    f64 = f.float().double().numpy()
    mu64, sig64 = f64.mean(axis=0), np.cov(f64, rowvar=False)
    assert np.abs(mu - mu64).max() <= 1e-6 * np.abs(mu64).max()
    assert np.abs(sigma - sig64).max() <= 1e-3 * np.abs(sig64).max()


def test_serving_sweep_through_the_kernels(dev):
    """`tools/serving_sweep` on the toy through the kernels: each variant's
    first run launches what `expected_launches` says for one run, and the
    chunked and packed runs equal the unchunked one to the bit."""
    from attentiondm_tpu_torch.tools.serving_sweep import sweep

    cfg, record = UNetConfig(**TOY), {}
    rows = sweep("cifar10.yml", 2, [2, 4], [None, 2, "shared", "packed"], reps=1, ucfg_override=cfg, device=dev,
                 record=record)
    assert len(rows) == 8 and all(r["img_per_sec"] > 0 for r in rows)
    for (b, ck), r in record.items():
        assert r["launches"] == checks.expected_launches(cfg, 2, b, attn_int8=False), (b, ck)
    for b in (2, 4):
        assert torch.equal(record[(b, 2)]["out"], record[(b, None)]["out"])
        assert torch.equal(record[(b, "packed")]["out"], record[(b, None)]["out"])
        assert torch.isfinite(record[(b, "shared")]["out"]).all()


def test_gate_gradients_on_the_card_match_the_cpu(dev, gen):
    """`unet_apply(gates=)` differentiated through autograd on the card
    (forward and backward under `exact_f32()`) against the CPU: the loss within 1e-5 relative,
    each gate logit's gradient within 1e-4 relative."""
    from attentiondm_tpu_torch.models.unet import map_tree, unet_apply
    from attentiondm_tpu_torch.ops.precision import exact_f32

    cfg = UNetConfig(**TOY)
    params = unet_init(gen, cfg, "cpu")
    x, t = torch.randn((2, 8, 8, 3), generator=gen), torch.tensor([3.0, 700.0])
    e = torch.randn(x.shape, generator=gen)
    out = {}
    for where in ("cpu", dev):
        logits = {k: torch.tensor(v, device=where, requires_grad=True)
                  for k, v in (("resblock", 0.3), ("attention", -0.4), ("temb", 1.1))}
        with exact_f32():  # the backward's convs too
            eps = unet_apply(map_tree(lambda a: a.to(where), params), cfg, x.to(where), t.to(where),
                             gates={k: torch.sigmoid(v) for k, v in logits.items()})
            loss = ((eps - e.to(where)) ** 2).sum()
            loss.backward()
        out[str(where)] = (loss.item(), {k: v.grad.item() for k, v in logits.items()})
    (wl, wg), (gl, gg) = out["cpu"], out[str(dev)]
    assert abs(gl - wl) <= 1e-5 * abs(wl)
    for k in wg:
        assert abs(gg[k] - wg[k]) <= 1e-4 * abs(wg[k]), (k, gg[k], wg[k])


def test_native_png_writer_on_the_card_machine(dev, tmp_path):
    """The C++ writer builds here with g++ and zlib; its PNGs hold the
    pixels `utils/images` writes."""
    from attentiondm_tpu_torch import native
    from attentiondm_tpu_torch.utils import images

    x = np.random.default_rng(0).uniform(0, 1, (6, 16, 24, 3)).astype(np.float32)
    assert native.native_available()
    assert native.write_png_batch(x, str(tmp_path / "n"), 3) == 6
    images.write_png_batch(x, str(tmp_path / "p"), 3)
    for i in range(3, 9):
        np.testing.assert_array_equal(images.read_png(str(tmp_path / "n" / f"{i}.png")),
                                      images.read_png(str(tmp_path / "p" / f"{i}.png")))


def _card_runner(tmp_path, name, **kw):
    """(args, config) of the runner's serving path on the toy UNet at W4A8 (batch 8, 3 quad steps)."""
    import argparse

    from attentiondm_tpu_torch.config import dict2namespace

    config = dict2namespace({
        "data": {"dataset": "CIFAR10", "image_size": 8, "channels": 3, "rescaled": True},
        "model": {"in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [8], "dropout": 0.0, "var_type": "fixedlarge", "ema": False},
        "diffusion": {"beta_schedule": "linear", "beta_start": 1e-4, "beta_end": 0.02,
                      "num_diffusion_timesteps": 1000},
        "sampling": {"batch_size": 8}})
    args = argparse.Namespace(
        seed=3, timesteps=3, skip_type="quad", eta=0.0, sample_type="generalized", fid=False, fid_stats=None,
        interpolation=False, sequence=False, execution="serving", fp32=False, bitwidth=4, a_bitwidth=8, normgroup=0,
        compute_dtype="float32", attn_variant="ddim", mixed_precision_attention=False, attn_int8=False,
        step_chunk=None, superbatch=None, shared_fold=False, pack_int4=False, weight_opt="biascorr",
        weight_refine="off", adaround_iters=10, calibrate_attention=False, calib_t_mode="real", sample_weight=2.0,
        calib_cache=None, ckpt_path=None, use_pretrained=False, num_samples=8,
        image_folder=str(tmp_path / name / "img"), log_path=str(tmp_path / name / "log"))
    for k, v in kw.items():
        setattr(args, k, v)
    return args, config


def test_two_ranks_on_one_card_serve_the_one_rank_sample(dev, tmp_path):
    """Two ranks sharing the card over gloo (`initialize_distributed` with
    the card named) through the runner's `--fid --execution serving`
    (`--calib_cache auto`: rank 0 calibrates and writes it): a batch of 8
    split 4 / 4 through the serving kernels, each rank's launches
    `expected_launches` at 4, the PNGs byte-equal to one rank's run on the
    card."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_parallel_worker import spawn_ranks

    from attentiondm_tpu_torch.runners.diffusion import Diffusion

    one, config = _card_runner(tmp_path, "one", fid=True)
    r = Diffusion(one, config)
    r.sample()
    flags = {k: r.serving["kwargs"][k] for k in ("attn_int8", "attn_ranges", "residual_dtype")}
    two, _ = _card_runner(tmp_path, "two", fid=True, calib_cache="auto")
    res = spawn_ranks(tmp_path, 2, "runner", {"device": "cuda", "runs": [(two, config, "sample")]})
    expected = checks.expected_launches(r.ucfg, 3, 4, **flags)
    for rank in res:
        assert rank[0]["counts"] == expected, (rank[0]["counts"], expected)
    assert expected["K1"] and expected["K2"] and expected["K3"]
    assert os.path.exists(os.path.join(two.log_path, "calib_cache.npz"))
    names = sorted(os.listdir(one.image_folder))
    assert names == sorted(os.listdir(two.image_folder)) and len(names) == 8
    for n in names:
        with open(os.path.join(one.image_folder, n), "rb") as f1, open(os.path.join(two.image_folder, n), "rb") as f2:
            assert f1.read() == f2.read(), n


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_sharded_forward_on_the_card_matches_the_cpu(dev, tmp_path, mode):
    """The tp 2 / sp 2 forward of two ranks sharing the card (gloo, host-
    staged collectives) against the one-process forward on the CPU."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_parallel_worker import spawn_ranks

    from attentiondm_tpu_torch.models.unet import map_tree, unet_apply

    toy = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)
    cfg = UNetConfig(**toy)
    params = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([17.0, 480.0], np.float32)
    want = unet_apply(params, cfg, torch.tensor(x), torch.tensor(t)).numpy()
    res = spawn_ranks(tmp_path, 2, "forward", dict(cfg=toy, params=map_tree(lambda a: a.numpy(), params), x=x, t=t,
                                                   mode=mode, mesh=(1, 2), device="cuda"))
    got = res[0]["eps"] if mode == "tp" else np.concatenate([r["eps"] for r in res], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-4)


# ADM's LSUN-bedroom UNet: K11 with heads, the GroupNorm kernels at eps 1e-5, one serving step of a toy ADM


@pytest.mark.parametrize("B,L,C", [(2, 1024, 512), (2, 256, 1024), (2, 64, 1024), (3, 64, 128)])
def test_k11_heads_match_plain(dev, gen, B, L, C):
    from attentiondm_tpu_torch.ops.attention import head_attention

    q, k, v = (_f(gen, (B, L, C), dev) for _ in range(3))
    heads = C // 64
    flash_attention.launches = 0
    got = head_attention(q, k, v, heads, scale=64 ** -0.5)
    assert flash_attention.launches == 1
    want = head_attention(q, k, v, heads, scale=64 ** -0.5, plain=True)
    assert checks.compare("K11", got, want)["ok"]
    qh, kh, vh = (a.reshape(B, L, heads, 64).transpose(1, 2) for a in (q, k, v))
    w = torch.softmax(torch.einsum("bhlc,bhmc->bhlm", qh, kh) * 64 ** -0.5, -1)
    ind = torch.einsum("bhlm,bhmc->bhlc", w, vh).transpose(1, 2).reshape(B, L, C)
    assert float((got - ind).abs().max()) < 1e-4


@pytest.mark.parametrize("B,HW,C,n_out,dtype", [
    (2, 65536, 256, 1, torch.float32), (2, 1024, 1536, 1, torch.float32), (2, 64, 2048, 1, torch.float32),
    (2, 4096, 768, 1, torch.float32), (2, 1024, 512, 3, torch.float32), (2, 256, 1024, 3, torch.bfloat16)])
def test_k4_at_adm_eps_bit_equal(dev, gen, B, HW, C, n_out, dtype):
    x = _f(gen, (B, HW, C), dev, 1e-2).to(dtype)
    gs, gb = _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev)
    qp = [(_f(gen, (C,), dev, 1.0, 20.0), _f(gen, (C,), dev), 8)] * n_out
    act = "swish" if n_out == 1 else "none"
    got = gn_act_quant(x, gs, gb, qp, act=act, eps=1e-5)
    want = gn_act_quant(x, gs, gb, qp, act=act, eps=1e-5, plain=True)
    at6 = gn_act_quant(x, gs, gb, qp, act=act, eps=1e-6, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[0], at6[0])


@pytest.mark.parametrize("H,N", [(256, 256), (128, 256), (64, 512), (32, 512), (16, 1024), (8, 1024)])
def test_k2_k6_at_adm_eps_with_the_scale_shift_fold(dev, gen, H, N):
    B = 2
    dot = _f(gen, (B, H, H, N), dev, 3e-2).to(torch.bfloat16)
    ones, zeros = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    gain, shift = _f(gen, (N,), dev, 0.3, 1.0), _f(gen, (N,), dev)
    gs, gb = _f(gen, (N,), dev, 0.1, 1.0), _f(gen, (N,), dev)
    s, z = _f(gen, (N,), dev, 1.0, 20.0), _f(gen, (N,), dev)
    args = (dot, ones, zeros, zeros.expand(B, -1), gs * gain, gb * gain + shift, s, z, 8)
    got = epilogue_gn_swish_quant(*args, eps=1e-5)
    assert torch.equal(got, epilogue_gn_swish_quant(*args, eps=1e-5, plain=True))
    assert not torch.equal(got, epilogue_gn_swish_quant(*args, eps=1e-6, plain=True))


def test_k3_and_k12_at_adm_eps(dev, gen):
    B, L, C = 2, 64, 1024
    x = _f(gen, (B, L, C), dev, 1e-2)
    gs, gb = _f(gen, (C,), dev, 0.1, 1.0), _f(gen, (C,), dev)
    qq = [(_f(gen, (C,), dev, 1.0, 20.0), _f(gen, (C,), dev), 8)] * 3
    w = [(_i8(gen, (C, C), -8, 7, dev), _f(gen, (C,), dev, 1e-3, 1e-2), _f(gen, (C,), dev, 1e-2))] * 3
    oq, ow = (_f(gen, (C,), dev, 1.0, 20.0), _f(gen, (C,), dev), 8), w[0]
    for eps in (1e-5, 1e-6):
        got = fused_attention_block(x, gs, gb, qq, w, oq, ow, scale=C ** -0.5, eps=eps)
        want = fused_attention_block(x, gs, gb, qq, w, oq, ow, scale=C ** -0.5, eps=eps, plain=True)
        assert checks.compare("K3", got, want)["ok"]
    Cr, H = 128, 8
    r = _f(gen, (B, H, H, Cr), dev, 1e-2)
    v = lambda: (_f(gen, (Cr,), dev, 1.0, 20.0), _f(gen, (Cr,), dev))  # noqa: E731
    g1, g2 = _i8(gen, (9 * Cr, Cr), -8, 7, dev), _i8(gen, (9 * Cr, Cr), -8, 7, dev)
    sb = (_f(gen, (Cr,), dev, 1e-4, 1e-3), _f(gen, (Cr,), dev, 1e-2))
    a = (r, _f(gen, (B, Cr), dev), gs[:Cr], gb[:Cr], v(), g1, sb, gs[:Cr], gb[:Cr], v(), g2, sb)
    got = resblock_pallas(*a, out_dtype=torch.float32, eps=1e-5)
    want = resblock_pallas(*a, out_dtype=torch.float32, eps=1e-5, plain=True)
    assert checks.compare("K12", got, want)["ok"]


def test_serving_step_adm_kernels_match_plain(dev, gen):
    """One serving forward of a toy ADM (128 channels, 1-2-2, heads of 64 at
    16^2 and 8^2): every kernel call against its plain version on the same
    inputs, the launch counts `checks.expected_launches` derives for ADM,
    and the sampler's launches over three steps."""
    from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler

    cfg = UNetConfig(ch=128, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(16, 8), resolution=32,
                     dropout=0.0, out_ch=6, model_type="adm", num_head_channels=64, learn_sigma=True, gn_eps=1e-5)
    B = 2
    params = unet_init(gen, cfg, dev)
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(3, dev)
    for st in qstates.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    runtime = prepare_serving_runtime(q, params, qstates)
    x = _f(gen, (B, 32, 32, 3), dev)
    t = torch.tensor(500.0, device=dev).expand(B)
    checks.reset_launches()
    records = []
    with checks.per_site(records):
        eps = serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0, attn_int8=False)
    assert checks.read_launches() == checks.expected_launches(cfg, 1, B, attn_int8=False)
    assert eps.shape == (B, 32, 32, 6) and torch.isfinite(eps).all()
    bad = [r for r in records if not r[2]["ok"]]
    assert not bad, bad
    assert {r[0] for r in records} == {"K1", "K2", "K4", "K11"}
    betas = torch.linspace(1e-4, 0.02, 1000, device=dev)
    sample = serving_ddim_sampler(q, params, qstates, [0, 333, 666], betas, runtime=runtime, attn_int8=False)
    checks.reset_launches()
    out = sample(x)
    assert checks.read_launches() == checks.expected_launches(cfg, 3, B, attn_int8=False)
    assert out.shape == x.shape and torch.isfinite(out).all()
