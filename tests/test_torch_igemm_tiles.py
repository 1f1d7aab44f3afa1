"""PyTorch port: what surrounds the redesigned K1 core and K11 that a CPU can
hold (the CUDA kernels run only on a GPU; see tests/test_torch_gpu.py).

  - `ops.pallas_conv.conv_tiles`, the M tiling that the wgmma kernel is
    handed: every output row of a launch is covered exactly once, in the
    kernel's row order, with every TMA box extent within the hardware's 256,
    at every K1 shape of the CIFAR-10, church and celeba-wide serving steps
    and at odd shapes;
  - the K-major weight copy (`k_major`, `ServingLayer.gqt`): it round-trips
    to JAX's fold layout bit for bit, and `prepare_serving_runtime` /
    `gather_step` carry it;
  - `int8_conv` on the CPU with the weights in either layout vs JAX's
    `int8_conv3_pallas` (interpret mode), `_conv3x3_int8_dot` and
    `int8_matmul`;
  - `flash_attention_ref` vs JAX's `flash_attention` (interpret mode) at
    D = 256 with key blocks of 256 and 512.

Inputs come from seeded numpy generators."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.ops import attention as j_attention
from attentiondm_tpu.ops.pallas_conv import int8_conv3_pallas as j_int8_conv3_pallas
from attentiondm_tpu.ops.quant_conv import _conv3x3_int8_dot as j_conv3x3_int8_dot
from attentiondm_tpu.ops.quant_conv import int8_matmul as j_int8_matmul
from attentiondm_tpu_torch.config import load_config
from attentiondm_tpu_torch.models.unet import UNetConfig, unet_init
from attentiondm_tpu_torch.ops import attention, checks
from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
from attentiondm_tpu_torch.ops.pallas_conv import SMS, _out_hw, conv_tile_rows, conv_tiles, int8_conv, k_major
from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas
from attentiondm_tpu_torch.quant.int8_serving import ServingLayer, gather_step, prepare_serving_runtime, runtime_nbytes
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i8(rng, shape, lo=-128, hi=127):
    return rng.integers(lo, hi + 1, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# conv_tiles
# ---------------------------------------------------------------------------


def _configs():
    celeba = dataclasses.replace(UNetConfig.from_config(load_config("celeba.yml")), attn_resolutions=(64, 32, 16))
    return {"cifar10": (UNetConfig(), 128), "church": (UNetConfig.from_config(load_config("church.yml")), 32),
            "celeba-wide": (celeba, 64)}


def _check_cover(B, Ho, Wo, ksize, stride, Np):
    t = conv_tiles(B, Ho, Wo, ksize, stride, Np)
    assert t.BM in (64, 128) and t.BN == 128
    assert 1 <= t.cols <= 256 and 1 <= t.rows <= 256 and 1 <= t.imgs <= 256  # a TMA box extent is at most 256
    assert t.cols * t.rows * t.imgs <= t.BM
    fB, fH, fW = (1, 1, B * Ho * Wo) if ksize == 1 else (B, Ho, Wo)  # a 1x1 conv is the flat GEMM
    assert t.cols <= fW and t.rows <= fH and t.imgs <= fB  # a box never exceeds the tensor
    assert t.grid == (-(-fW // t.cols), -(-fH // t.rows), -(-fB // t.imgs), Np // 128)
    m = conv_tile_rows(t, B, Ho, Wo, ksize)
    assert tuple(m.shape) == (t.grid[0] * t.grid[1] * t.grid[2], t.BM)
    rows = m[m >= 0]
    M = B * Ho * Wo
    assert rows.numel() == M and torch.equal(torch.sort(rows).values, torch.arange(M))  # each row exactly once
    # within a tile the kernel's row order is the output's: rows ascend
    asc = torch.where(m >= 0, m, torch.full_like(m, 2 * M))
    assert bool((asc[:, 1:] >= asc[:, :-1]).all())
    if t.BM == 128:  # 128-row tiles only where they give every SM one
        assert m.shape[0] * t.grid[3] >= SMS
    return t


@pytest.mark.parametrize("batch", ["own", 2, 3])
@pytest.mark.parametrize("path", ["cifar10", "church", "celeba-wide"])
def test_conv_tiles_cover_every_serving_shape(path, batch):
    """Every K1 launch of one serving step (`ops.checks.conv_plan`) at the
    path's own batch and at batches 2 and 3."""
    cfg, own = _configs()[path]
    B = own if batch == "own" else batch
    k1 = checks.conv_plan(cfg)[0]
    shapes = sorted({(H, Np, k, s) for _name, H, _Cp, Np, k, s, _mode in k1})
    assert len(shapes) >= 10
    for H, Np, k, s in shapes:
        Hp = H + 2 if (k == 3 and s == 1) else H + 1 if k == 3 else H
        Ho, Wo = _out_hw(Hp, Hp, k, s)
        assert Ho == (H if s == 1 else H // 2)
        _check_cover(B, Ho, Wo, k, s, Np)


@pytest.mark.parametrize("B,Ho,Wo,ksize,stride,Np", [
    (32, 256, 256, 3, 1, 128),   # a tile is half an image row
    (3, 4, 256, 3, 1, 128), (2, 300, 300, 3, 1, 128),  # ragged row parts
    (128, 4, 4, 3, 1, 256), (3, 4, 4, 3, 1, 128), (37, 8, 8, 3, 1, 256),  # a tile spans images
    (3, 14, 14, 3, 1, 128), (2, 5, 37, 3, 1, 128), (2, 112, 112, 3, 1, 128),  # off the powers of two
    (3, 8, 8, 3, 2, 128), (2, 7, 7, 3, 2, 256), (3, 3, 6, 3, 2, 128),  # stride 2, odd halo'd sizes
    (3, 1, 50, 1, 1, 128), (64, 64, 64, 1, 1, 128), (1, 1, 1, 1, 1, 512),  # the flat 1x1 GEMM
])
def test_conv_tiles_cover_odd_shapes(B, Ho, Wo, ksize, stride, Np):
    t = _check_cover(B, Ho, Wo, ksize, stride, Np)
    if (B, Ho, Wo) == (32, 256, 256):
        assert (t.BM, t.cols, t.rows, t.imgs) == (128, 128, 1, 1)
    if (B, Ho, Wo) == (128, 4, 4):
        assert (t.BM, t.cols, t.rows, t.imgs) == (64, 4, 4, 4)  # 64 tiles x 2: 128-row tiles would give 32


def test_conv_tiles_stride2_output_size_matches_out_hw():
    """The stride-2 tiling is over output pixels: _out_hw of the (0, 1) halo'd
    input, at even and odd sizes."""
    for H in (4, 5, 8, 15, 16, 33):
        Ho, Wo = _out_hw(H + 1, H + 1, 3, 2)
        assert Ho == Wo == (H - 2) // 2 + 1
        _check_cover(3, Ho, Wo, 3, 2, 128)


# ---------------------------------------------------------------------------
# the K-major weight copy
# ---------------------------------------------------------------------------


def test_k_major_round_trips_bit_for_bit():
    rng = np.random.default_rng(0)
    gq = _t(_i8(rng, (3, 9 * 128, 256), -8, 7))
    gqt = k_major(gq)
    assert tuple(gqt.shape) == (3, 256, 9 * 128) and gqt.is_contiguous() and gqt.dtype == torch.int8
    assert torch.equal(k_major(gqt), gq)
    assert torch.equal(gqt[1], gq[1].t())


TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)


@pytest.fixture(scope="module")
def toy_runtime():
    cfg = UNetConfig(**TOY)
    params = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(2, "cpu")
    for st in qstates.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    return prepare_serving_runtime(q, params, qstates)


def test_prepare_serving_runtime_stores_the_k_major_copy(toy_runtime):
    assert toy_runtime
    for name, lay in toy_runtime.items():
        S, K, Np = lay.gq.shape
        assert tuple(lay.gqt.shape) == (S, Np, K) and lay.gqt.is_contiguous(), name
        assert torch.equal(lay.gqt.transpose(1, 2), lay.gq), name
    held = runtime_nbytes(toy_runtime)
    weights = sum(lay.gq.numel() for lay in toy_runtime.values())
    assert weights < held < 2 * weights  # one layout held: `gq` is a view of `gqt`


def test_gather_step_carries_the_k_major_copy(toy_runtime):
    for i in (0, 1):
        for name, lay in gather_step(toy_runtime, i).items():
            assert torch.equal(lay.gqt, toy_runtime[name].gqt[i]) and torch.equal(lay.gqt.t(), lay.gq), name
            assert lay.gqt.is_contiguous()


def test_serving_layer_without_the_copy_makes_it():
    rng = np.random.default_rng(1)
    gq = _t(_i8(rng, (2, 128, 256), -8, 7))
    v = torch.zeros((2, 256))
    lay = ServingLayer(gq, v, v, torch.zeros((2, 128)), torch.zeros((2, 128)))
    assert torch.equal(lay.gqt, gq.transpose(1, 2)) and lay.gqt.is_contiguous()


# ---------------------------------------------------------------------------
# int8_conv with either weight layout, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["fold", "k_major", "both"])
@pytest.mark.parametrize("out_dtype", ["int32", "bfloat16"])
def test_int8_conv_either_layout_matches_jax_pallas_conv(out_dtype, layout):
    rng = np.random.default_rng(11)
    H, Cp, Np = 8, 128, 256
    xp = _i8(rng, (2, H + 2, H + 2, Cp))
    gq = _i8(rng, (9 * Cp, Np), -8, 7)
    inv_ws = rng.uniform(1e-4, 1e-3, Np).astype(np.float32)
    zcbias = rng.standard_normal(Np).astype(np.float32)
    w = dict(fold=(_t(gq), None), k_major=(None, k_major(_t(gq))), both=(_t(gq), k_major(_t(gq))))[layout]
    got = int8_conv(_t(xp), w[0], _t(inv_ws), _t(zcbias), ksize=3, out_dtype=getattr(torch, out_dtype), gqt=w[1])
    want = np.asarray(j_int8_conv3_pallas(jnp.asarray(xp), jnp.asarray(gq), jnp.asarray(inv_ws),
                                          jnp.asarray(zcbias), out_dtype=getattr(jnp, out_dtype)))
    if out_dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:  # one rounding of the same f32: within 1 bf16 ulp
        g, wf = got.float().numpy().astype(np.float64), want.astype(np.float64)
        assert (np.abs(g - wf) <= np.maximum(np.abs(wf), 1e-30) * 2.0 ** -7).all()


@pytest.mark.parametrize("layout", ["fold", "k_major"])
def test_int8_conv_int32_modes_either_layout_match_k13_and_k5(layout):
    rng = np.random.default_rng(5)
    B, H, C, N = 2, 8, 256, 128
    xp = _i8(rng, (B, H + 2, H + 2, C))
    gq = _i8(rng, (9 * C, N), -8, 7)

    def w(g):
        return dict(gq=_t(g)) if layout == "fold" else dict(gq=None, gqt=k_major(_t(g)))

    got = int8_conv(_t(xp), **w(gq), ksize=3).reshape(B * H * H, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_conv3x3_int8_dot(jnp.asarray(xp), jnp.asarray(gq),
                                                                             H, H, C, N)))
    x2 = _i8(rng, (B, H, H, 384))
    w2 = _i8(rng, (384, 256), -8, 7)
    got = int8_conv(_t(x2), **w(w2), ksize=1).reshape(-1, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_int8_matmul(jnp.asarray(x2.reshape(-1, 384)),
                                                                        jnp.asarray(w2))))


def test_int8_conv_rejects_weights_of_the_wrong_shape():
    x = torch.zeros((1, 6, 6, 128), dtype=torch.int8)
    g = torch.zeros((9 * 128, 256), dtype=torch.int8)
    with pytest.raises(ValueError):
        int8_conv(x, None)
    with pytest.raises(ValueError):  # a fold-layout tensor handed in as the K-major copy
        int8_conv(x, g, gqt=g)
    with pytest.raises(ValueError):
        int8_conv(x, g.t().contiguous())
    assert int8_conv(x, g, gqt=k_major(g)).shape == (1, 4, 4, 256)


def test_k3_and_k12_take_the_k_major_copies_on_the_cpu():
    """The plain versions read the fold layout; handing the K-major copies in
    as well (the serving path's call) changes nothing."""
    rng = np.random.default_rng(7)
    B, L, C = 2, 16, 128

    def weights():
        g = _t(_i8(rng, (C, C), -8, 7))
        return g, torch.full((C,), 1e-4), torch.zeros(C)

    x = torch.from_numpy(rng.standard_normal((B, L, C)).astype(np.float32)).to(torch.bfloat16)
    quant = (torch.full((C,), 30.0), torch.zeros(C), 8)
    ws = [weights() for _ in range(4)]
    args = (x, torch.ones(C), torch.zeros(C), [quant] * 3)
    want = fused_attention_block(*args, ws[:3], quant, ws[3], scale=C ** -0.5)
    got = fused_attention_block(*args, [(*w, k_major(w[0])) for w in ws[:3]], quant, (*ws[3], k_major(ws[3][0])),
                                scale=C ** -0.5)
    assert torch.equal(got, want)

    H = 4
    g1, g2 = (_t(_i8(rng, (9 * C, C), -8, 7)) for _ in range(2))
    r = torch.from_numpy(rng.standard_normal((B, H, H, C)).astype(np.float32)).to(torch.bfloat16)
    sb, q = (torch.full((C,), 1e-4), torch.zeros(C)), (torch.full((C,), 30.0), torch.zeros(C))
    rargs = (r, torch.zeros((B, C)), torch.ones(C), torch.zeros(C), q, g1, sb, torch.ones(C), torch.zeros(C), q, g2, sb)
    assert torch.equal(resblock_pallas(*rargs, g1_t=k_major(g1), g2_t=k_major(g2)), resblock_pallas(*rargs))


# ---------------------------------------------------------------------------
# K11's plain version at D = 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_k", [256, 512])
def test_flash_attention_ref_matches_jax_at_d256(block_k):
    rng = np.random.default_rng(block_k)
    B, L, D = 1, 1024, 256
    q, k, v = (rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_attention.flash_attention(*map(jnp.asarray, (q, k, v)), block_k=block_k, interpret=True))
    before = attention.flash_attention.launches
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), block_k=block_k)
    assert attention.flash_attention.launches == before  # a CPU tensor takes the plain version
    assert torch.equal(got, attention.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), block_k=block_k))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
