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
@pytest.mark.parametrize("C", [128, 256, 512])
@pytest.mark.parametrize("L", [16, 64, 256, 1024])
def test_k3_tensor_core_cores_match_plain(dev, gen, L, C, B, int8_core):
    """K3's redesigned core (3xTF32 f32 mode; s8 logits in the int8 mode) at
    every width, from a map shorter than a key tile to the longest K3 takes
    (L = 1024: 32 queries a block), at batch 1 and 3."""
    args = _k3_args(gen, dev, B, L, C)
    before = fused_attention_block.launches
    got = fused_attention_block(*args, scale=C ** -0.5, int8_core=int8_core)
    assert fused_attention_block.launches == before + 1
    fig = checks.compare("K3", got, fused_attention_block(*args, scale=C ** -0.5, int8_core=int8_core, plain=True))
    assert fig["ok"], fig


@pytest.mark.parametrize("B,L,C", [(3, 256, 256), (1, 1024, 512), (2, 72, 128), (3, 16, 512), (1, 576, 256)])
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


@pytest.mark.parametrize("B,L,C", [(128, 256, 256), (32, 64, 512), (3, 1024, 128), (2, 100, 256)])
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
    sample = serving_ddim_sampler(q, params, qstates, [0], betas)
    checks.reset_launches()
    with pytest.raises(NotImplementedError, match=r"mid\.attn_1 \(L=16, C=384\) -> K3"):
        sample(_f(gen, (1, 8, 8, 3), dev))
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
                                 torch.full((B,), 500.0, device=dev), 0, **flags)
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
        eps = serving_unet_apply(params, cfg, q, runtime, qstates, x, t, 0, attn_int8=False, **levers)
    assert checks.read_launches() == checks.expected_launches(cfg, 1, B, attn_int8=False, **levers)
    assert torch.isfinite(eps).all()
    bad = [r for r in records if not r[2]["ok"]]
    assert not bad, bad
    if toy == "church" and not levers:
        assert {r[0] for r in records} == {"K1", "K2", "K6", "K3"}
    if toy == "levers" and len(levers) == 3:
        assert {"K4", "K7", "K12"} <= {r[0] for r in records}
