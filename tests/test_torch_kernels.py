"""PyTorch port vs the JAX package: the kernels of the serving path,
through their plain versions (the CUDA kernels run only on a GPU; see
tests/test_torch_gpu.py).

  K1  attentiondm_tpu_torch.ops.pallas_conv.int8_conv: the int8 conv core, vs
      the serving convs of quant/int8_serving.py, the Pallas conv
      int8_conv3_pallas (interpret mode) and the int32 Pallas kernels it also
      replaces, _conv3x3_int8_dot (K13) and int8_matmul (K5);
  K2  ops.fused_gn.epilogue_gn_swish_quant;
  K6  ops.fused_gn.epilogue_gn_swish_quant_blocked, and the routing between
      K2 and K6;
  K3  ops.int8_attention.fused_attention_block;
  K4  ops.fused_gn.gn_act_quant;
  K7  ops.fused_gn.epilogue_residual_gn_stats and gn_finalize_sums;
  K12 ops.pallas_resblock.resblock_pallas, and JAX's routing predicates.

Inputs come from seeded numpy generators."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from attentiondm_tpu.ops import fused_gn as jfg
from attentiondm_tpu.ops.fused_gn import epilogue_gn_swish_quant as j_epilogue_gn_swish_quant
from attentiondm_tpu.ops.int8_attention import fused_attention_block as j_fused_attention_block
from attentiondm_tpu.ops import pallas_conv as jpc
from attentiondm_tpu.ops import pallas_resblock as jrb
from attentiondm_tpu.ops.pallas_conv import int8_conv3_pallas as j_int8_conv3_pallas
from attentiondm_tpu.ops.quant_conv import _conv3x3_int8_dot as j_conv3x3_int8_dot
from attentiondm_tpu.ops.quant_conv import int8_matmul as j_int8_matmul
from attentiondm_tpu.quant import int8_serving as js
from attentiondm_tpu_torch.ops import _build
from attentiondm_tpu_torch.ops import fused_gn as tfg
from attentiondm_tpu_torch.ops import pallas_conv as tpc
from attentiondm_tpu_torch.ops import pallas_resblock as trb
from attentiondm_tpu_torch.ops.fused_gn import (
    epilogue_gn_swish_quant,
    epilogue_gn_swish_quant_blocked,
    epilogue_gn_swish_quant_whole,
    epilogue_residual_gn_stats,
    epilogue_route,
    gn_act_quant,
)
from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
from attentiondm_tpu_torch.ops.pallas_conv import int8_conv
from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas
from attentiondm_tpu_torch.quant import int8_serving as ts


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


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp (elementwise, float64)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.maximum(np.abs(want), np.finfo(np.float32).tiny) * 2.0 ** -7
    return np.abs(got - want) / ulp


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

# (kind, H, C, Np): the toy serving convs (C = 128 .. 512, conv_out's Np = 128),
# plus C = 64, which the caller pads to Cp = 128
K1_CASES = [
    ("conv3", 8, 128, 128), ("conv3", 4, 384, 256), ("conv3", 4, 512, 256), ("conv3", 8, 64, 128),
    ("down", 8, 128, 128), ("down", 4, 256, 256),
    ("conv1", 8, 256, 128), ("conv1", 4, 384, 256), ("conv1", 4, 512, 256),
]


@pytest.mark.parametrize("kind,H,C,Np", K1_CASES, ids=[f"{k}-H{h}-C{c}-N{n}" for k, h, c, n in K1_CASES])
def test_k1_serving_convs_match_jax(kind, H, C, Np):
    """The serving path's int8 convs (quantized-zero halo, stride-2 downsample,
    1x1 shortcut) through K1's plain version vs JAX's XLA int8 convs: int32
    products, exactly equal."""
    rng = np.random.default_rng(H * C + Np)
    a_bit = 8
    xq = _i8(rng, (2, H, H, C))
    zp = np.round(rng.uniform(-60, 60, C)).astype(np.float32)
    Cp = -(-C // 128) * 128
    gq = _i8(rng, ((1 if kind == "conv1" else 9) * Cp, Np), -8, 7)
    if kind == "conv3":
        got = ts.int8_conv3_qzero(_t(xq), _t(zp), a_bit, _t(gq))
        want = js.int8_conv3_qzero(jnp.asarray(xq), jnp.asarray(zp), a_bit, jnp.asarray(gq))
    elif kind == "down":
        got = ts.int8_conv3_qzero_down(_t(xq), _t(zp), a_bit, _t(gq))
        want = js.int8_conv3_qzero_down(jnp.asarray(xq), jnp.asarray(zp), a_bit, jnp.asarray(gq))
    else:
        got = ts.int8_conv(_t(xq), _t(gq), 1)
        want = js.int8_conv(jnp.asarray(xq), jnp.asarray(gq), 1)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("out_dtype", ["int32", "bfloat16"])
@pytest.mark.parametrize("H,Cp,Np", [(8, 128, 128), (4, 256, 256)])
def test_k1_matches_jax_pallas_conv(H, Cp, Np, out_dtype):
    """K1's plain version vs the TPU kernel it replaces (interpret mode):
    int32 exactly equal; bf16 within 1 ulp (one rounding of the same f32)."""
    rng = np.random.default_rng(H + Cp + Np)
    xp = _i8(rng, (2, H + 2, H + 2, Cp))
    gq = _i8(rng, (9 * Cp, Np), -8, 7)
    inv_ws = rng.uniform(1e-4, 1e-3, Np).astype(np.float32)
    zcbias = rng.standard_normal(Np).astype(np.float32)
    got = int8_conv(_t(xp), _t(gq), _t(inv_ws), _t(zcbias), ksize=3, out_dtype=getattr(torch, out_dtype))
    want = np.asarray(j_int8_conv3_pallas(jnp.asarray(xp), jnp.asarray(gq), jnp.asarray(inv_ws),
                                          jnp.asarray(zcbias), out_dtype=getattr(jnp, out_dtype)))
    if out_dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert _bf16_ulps(got.float().numpy(), want.astype(np.float32)).max() <= 1.0


def test_k1_int32_modes_match_k13_and_k5():
    """K1's 3x3 int32 mode computes the interception path's Pallas 3x3 conv
    (K13), and its 1x1 mode the Pallas int8 matmul (K5): exactly equal."""
    rng = np.random.default_rng(5)
    B, H, C, N = 2, 8, 256, 128
    xp = _i8(rng, (B, H + 2, H + 2, C))
    gq = _i8(rng, (9 * C, N), -8, 7)
    got = int8_conv(_t(xp), _t(gq), ksize=3).reshape(B * H * H, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_conv3x3_int8_dot(jnp.asarray(xp), jnp.asarray(gq),
                                                                             H, H, C, N)))
    x2 = _i8(rng, (B, H, H, 384))
    w2 = _i8(rng, (384, 256), -8, 7)
    got = int8_conv(_t(x2), _t(w2), ksize=1).reshape(-1, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_int8_matmul(jnp.asarray(x2.reshape(-1, 384)),
                                                                        jnp.asarray(w2))))


def test_k1_rejects_shapes_it_does_not_take():
    x = torch.zeros((1, 6, 6, 128), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        int8_conv(x, torch.zeros((25 * 128, 128), dtype=torch.int8), ksize=5)
    with pytest.raises(NotImplementedError):
        int8_conv(x, torch.zeros((128, 128), dtype=torch.int8), ksize=1, stride=2)
    with pytest.raises(ValueError):  # Cp off the 128 grid
        int8_conv(torch.zeros((1, 6, 6, 96), dtype=torch.int8), torch.zeros((9 * 96, 128), dtype=torch.int8))


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _k2_inputs(rng, HW, N, dtype):
    B = 2
    H = int(HW ** 0.5)
    if dtype == "bfloat16":  # dot_bf16: conv1's output already dequantized, identity epilogue
        dot = (rng.standard_normal((B, H, H, N)) * 1.5 + 0.2).astype(ml_dtypes.bfloat16)
        inv_ws, zcbias = np.ones(N, np.float32), np.zeros(N, np.float32)
    else:  # the int32 accumulator with its dequant
        dot = rng.integers(-20000, 20000, (B, H, H, N)).astype(np.int32)
        inv_ws = rng.uniform(5e-5, 2e-4, N).astype(np.float32)
        zcbias = rng.standard_normal(N).astype(np.float32)
    temb = rng.standard_normal((B, N)).astype(np.float32)
    gn_scale = (1 + 0.1 * rng.standard_normal(N)).astype(np.float32)
    gn_bias = (0.1 * rng.standard_normal(N)).astype(np.float32)
    rmin, rmax = rng.uniform(-0.6, -0.2, N), rng.uniform(2.0, 5.0, N)
    act_scale = (255 / (rmax - rmin)).astype(np.float32)
    act_zp = (np.round(act_scale * rmin) + 128).astype(np.float32)
    return dot, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp


def _torch_args(args):
    ta = [_t(a.astype(np.float32)) if a.dtype == ml_dtypes.bfloat16 else _t(a) for a in args]
    if args[0].dtype == ml_dtypes.bfloat16:
        ta[0] = ta[0].to(torch.bfloat16)  # exact: the values are bf16
    return ta


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
@pytest.mark.parametrize("HW,N", [(64, 128), (16, 256)])
def test_k2_matches_jax(HW, N, dtype):
    """int8 equal, except 1 LSB on a few elements: both sum the GroupNorm
    statistics in f32, but in different orders where XLA's CPU reduction
    leaves the windowed order of `fused_gn.window_sum`, and JAX takes
    rsqrt and sigmoid where the port takes 1/sqrt and 1/(1+exp), so a rare
    value crosses a rounding tie (measured with f32 sums: 1 LSB on at most
    1.5e-5 of the elements, in 3 of 72 seeded cases over these shapes and
    (256, 128); 0 at these seeds)."""
    rng = np.random.default_rng(HW + N + len(dtype))
    args = _k2_inputs(rng, HW, N, dtype)
    got = epilogue_gn_swish_quant(*_torch_args(args), 8).numpy().astype(np.int32)
    want = np.asarray(j_epilogue_gn_swish_quant(*map(jnp.asarray, args), 8)).astype(np.int32)
    d = np.abs(got - want)
    assert d.max() <= 1 and (d > 0).mean() <= 3e-5, (d.max(), (d > 0).mean())


def _offset_case(rng, HW, N=128, B=2):
    """GroupNorm input with a large common offset (mean 50, std 1): f32
    E[x^2] - mu^2 cancels to about 2.4e-4 of the variance."""
    dot = rng.integers(-30000, 30000, (B, HW, N)).astype(np.int32)  # std about 17320
    return (dot, np.full(N, 1 / 17320.0, np.float32), np.full(N, 50.0, np.float32),
            np.zeros((B, N), np.float32), np.ones(N, np.float32), np.zeros(N, np.float32),
            np.full(N, 255 / 6.0, np.float32), np.zeros(N, np.float32))


def _f64_sums_normalize(h):
    """For contrast only: the statistics summed in f64 and rounded once to f32."""
    B, HW, N = h.shape
    g = min(tfg.GROUPS, N)
    xd = h.double().reshape(B, HW, g, N // g)
    mean_g, rstd_g = tfg._finalize(xd.sum(dim=(1, 3)).float(), (xd * xd).sum(dim=(1, 3)).float(),
                                   1.0 / (HW * (N // g)))
    return tfg._normalize(h, mean_g, rstd_g, torch.ones(N), torch.zeros(N))


def test_gn_sums_in_f32_agree_with_jax_where_f64_sums_do_not():
    """At a large common offset (HW 4096, mean 50, std 1) f32 E[x^2] - mu^2
    cancels visibly.  The port's plain statistics, summed in f32, give
    JAX's `_gn_normalize` (XLA on the CPU; K2's Pallas kernel in interpret
    mode for the codes) to 1 ulp, where sums in f64 rounded once to f32 do
    not.  Measured over 4 seeds and HW 256..4096: normalized values
    within 2.4e-7 of JAX's and at most 1.0e-4 of the int8 codes one apart
    (rsqrt and sigmoid vs 1/sqrt and 1/(1+exp)); f64 sums land 4.3e-4..1.1e-3
    away and flip 1.7e-3..2.6e-3 of the codes.  Bounds: 1e-6 and 4e-4."""
    rng = np.random.default_rng(0)
    HW = 4096
    args = _offset_case(rng, HW)
    dot, inv_ws, zcbias = (_t(a) for a in args[:3])
    h = dot.float() * inv_ws + zcbias
    onehot, g, cg = jfg._group_onehots(128, 32)
    want = np.asarray(jfg._gn_normalize(jnp.asarray(h.numpy()), onehot, 1.0 / (HW * cg),
                                        jnp.ones(128), jnp.zeros(128)))
    got = tfg.gn_normalize(h, torch.ones(128), torch.zeros(128)).numpy()
    f64 = _f64_sums_normalize(h).numpy()
    assert np.abs(got - want).max() <= 1e-6 < np.abs(f64 - want).max()

    shaped = (args[0].reshape(2, 64, 64, 128),) + args[1:]
    codes_jax = np.asarray(j_epilogue_gn_swish_quant(*map(jnp.asarray, shaped), 8, interpret=True))
    codes = epilogue_gn_swish_quant(*map(_t, shaped), 8).numpy()
    codes_f64 = tfg.quant_i8(tfg.swish(torch.from_numpy(f64)), _t(args[6]), _t(args[7]), 8).numpy()
    assert (codes != codes_jax).mean() <= 4e-4 < (codes_f64.reshape(codes_jax.shape) != codes_jax).mean()


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_k6_matches_jax_blocked(dtype):
    """K6's plain version vs JAX's two-pass blocked kernel (interpret mode)
    at (B=1, 64x64, N=128).  Both sum in f32, the port per 1024-row chunk,
    JAX per 4096-row block, and JAX takes rsqrt and sigmoid, so a rare value
    crosses a rounding tie (measured over 9 seeds each: 1 LSB on at most
    5.7e-6 of the elements; at these seeds 0 (bf16) and 1.9e-6 (int32);
    bound about 4x)."""
    rng = np.random.default_rng(64 + len(dtype))
    args = list(_k2_inputs(rng, 4096, 128, dtype))
    args[0], args[3] = args[0][:1], args[3][:1]  # batch 1
    got = epilogue_gn_swish_quant_blocked(*_torch_args(args), 8).numpy().astype(np.int32)
    want = np.asarray(jfg.epilogue_gn_swish_quant_blocked(*map(jnp.asarray, args), 8, interpret=True))
    d = np.abs(got - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 2.5e-5, (d.max(), (d > 0).mean())


def _jax_route(monkeypatch, shape, dtype):
    """Which path JAX's epilogue_gn_swish_quant takes at this shape, read
    off its calls while it is traced (nothing runs)."""
    seen = []

    def record(name):
        def fn(dot, *a, **k):
            seen.append(name)
            return jnp.zeros(dot.shape, jnp.int8)
        return fn

    monkeypatch.setattr(jfg, "epilogue_gn_swish_quant_blocked", record("K6"))
    monkeypatch.setattr(jfg, "epilogue_gn_swish_quant_reference", record("xla"))
    B, N = shape[0], shape[-1]
    vec = jax.ShapeDtypeStruct((N,), jnp.float32)
    jax.eval_shape(functools.partial(jfg.epilogue_gn_swish_quant, a_bit=8, interpret=True),
                   jax.ShapeDtypeStruct(shape, dtype), vec, vec, jax.ShapeDtypeStruct((B, N), jnp.float32),
                   vec, vec, vec, vec)
    return seen[0] if seen else "K2"


# (B, H, W, N) around the 4 MiB whole-image edge: HW * N * (itemsize + 1)
ROUTES = [
    ((2, 1365, 8, 128), "bfloat16"), ((2, 1366, 8, 128), "bfloat16"), ((1, 128, 128, 128), "bfloat16"),
    ((1, 256, 256, 128), "bfloat16"), ((2, 682, 8, 256), "bfloat16"), ((2, 683, 8, 256), "bfloat16"),
    ((1, 64, 64, 512), "bfloat16"), ((2, 819, 8, 128), "int32"), ((2, 820, 8, 128), "int32"),
    ((1, 64, 64, 256), "int32"), ((1, 128, 128, 96), "bfloat16"), ((1, 105, 105, 128), "bfloat16"),
    ((1, 64, 64, 1032), "bfloat16"),
]


@pytest.mark.parametrize("shape,dtype", ROUTES, ids=[f"{'x'.join(map(str, s))}-{d}" for s, d in ROUTES])
def test_epilogue_routes_like_jax(monkeypatch, shape, dtype):
    """The port sends a conv1 output to K2 or K6 at exactly the shapes where
    JAX's dispatcher takes its whole-image or its blocked kernel.  Where JAX
    takes its XLA reference (over the budget, N off the 128 grid or HW not a
    multiple of 8), the port takes K2 where K2's plan does (N a multiple of 8
    up to 1024) and raises, naming the shape, elsewhere."""
    want = _jax_route(monkeypatch, shape, getattr(jnp, dtype))
    if want == "xla" and shape[-1] % 8 == 0 and shape[-1] <= 1024:
        want = "K2"
    if want == "xla":
        with pytest.raises(NotImplementedError, match=rf"HW={shape[1] * shape[2]}, N={shape[-1]}"):
            epilogue_route(shape, getattr(torch, dtype))
        with pytest.raises(NotImplementedError):
            epilogue_gn_swish_quant(torch.zeros(shape, dtype=getattr(torch, dtype)), *(torch.ones(shape[-1]),) * 2,
                                    torch.zeros(shape[0], shape[-1]), *(torch.ones(shape[-1]),) * 4, 8)
    else:
        assert epilogue_route(shape, getattr(torch, dtype)) == want


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _k3_inputs(rng, L, C):
    B = 2
    x = (rng.standard_normal((B, L, C)) * 2 + 0.3).astype(ml_dtypes.bfloat16)
    gn_scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    gn_bias = (0.1 * rng.standard_normal(C)).astype(np.float32)

    def quant(a_bit, lo, hi):
        rmin, rmax = rng.uniform(lo, lo / 2, C), rng.uniform(hi / 2, hi, C)
        s = ((2 ** a_bit - 1) / (rmax - rmin)).astype(np.float32)
        return s, (np.round(s * rmin) + 2 ** (a_bit - 1)).astype(np.float32), a_bit

    def weights():
        return (_i8(rng, (C, C), -8, 7), rng.uniform(1e-4, 3e-4, C).astype(np.float32),
                (0.1 * rng.standard_normal(C)).astype(np.float32))

    qkv_quant = [quant(8, -4, 4), quant(6, -4, 4), quant(8, -4, 4)]  # W4A8: k at a_bit 6
    return x, gn_scale, gn_bias, qkv_quant, [weights() for _ in range(3)], quant(8, -3, 3), weights()


def _to_torch(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(a) for a in tree)
    if isinstance(tree, np.ndarray):
        return _t(tree)
    return tree


def _to_jax(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(a) for a in tree)
    if isinstance(tree, np.ndarray):
        return jnp.asarray(tree)
    return tree


@pytest.mark.parametrize("L,C", [(64, 128), (16, 256), (16, 512), (64, 512)])
def test_k3_matches_jax(L, C):
    """The whole attention block, bf16 residual: at least 99% of elements
    within 1 bf16 ulp and a small mean relative error.  Both cores sum in
    f32 in different orders, so a few int8 codes of q/k/v or proj_out's
    input cross a rounding tie; with B = 2 and L = 16 one flipped code of
    proj_out's input moves a whole row, 1/32 of the output.  Measured with
    f32 sums over 24 seeded cases at these four shapes: mean rel err at most
    2.1e-4, at least 98.5% within 1 ulp; at these seeds at most 5.5e-7 and
    100%."""
    rng = np.random.default_rng(L + C)
    x, *rest = _k3_inputs(rng, L, C)
    got = fused_attention_block(_t(x.astype(np.float32)).to(torch.bfloat16), *_to_torch(rest), scale=C ** -0.5)
    want = j_fused_attention_block(jnp.asarray(x), *_to_jax(rest), scale=C ** -0.5)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    within = (_bf16_ulps(got, want) <= 1.0).mean()
    assert rel < 1.5e-4 and within >= 0.99, (rel, within)


@pytest.mark.parametrize("L,C", [(64, 128), (16, 256), (64, 512)])
def test_k3_matches_jax_at_f32(L, C):
    """The whole attention block at a float32 residual (JAX's default
    stream: nothing rounds the output): the plain version against the TPU
    kernel in interpret mode.  The core sums in f32 in another order, so a
    proj_out input code on a tie may move its row; measured at these seeds:
    mean rel err at most 6.6e-9, at least 98.3% of the elements within 2 f32
    ulp (bounded at 4x: 2.6e-8, and at most 6.7% off)."""
    rng = np.random.default_rng(L + C + 1)
    x, *rest = _k3_inputs(rng, L, C)
    x = x.astype(np.float32) + (1e-3 * rng.standard_normal(x.shape)).astype(np.float32)  # off the bf16 grid
    got = fused_attention_block(_t(x), *_to_torch(rest), scale=C ** -0.5)
    want = np.asarray(j_fused_attention_block(jnp.asarray(x), *_to_jax(rest), scale=C ** -0.5))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    within = (np.abs(got - want) <= 2 * np.finfo(np.float32).eps * np.abs(want)).mean()
    assert rel < 2.6e-8 and within >= 0.933, (rel, within)


# ---------------------------------------------------------------------------
# K4, K7, K12
# ---------------------------------------------------------------------------


def _quant_np(rng, C, a_bit, lo, hi):
    rmin, rmax = rng.uniform(lo, lo / 2, C), rng.uniform(hi / 2, hi, C)
    s = ((2 ** a_bit - 1) / (rmax - rmin)).astype(np.float32)
    return s, (np.round(s * rmin) + 2 ** (a_bit - 1)).astype(np.float32), a_bit


def _gn_np(rng, C):
    return (1 + 0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)


def _bf16_t(a):
    return _t(a.astype(np.float32)).to(torch.bfloat16)  # exact: the values are bf16


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("HW,C,n_out,act", [(64, 128, 1, "swish"), (64, 256, 1, "swish"), (64, 256, 3, "none"),
                                            (16, 384, 2, "swish")])
def test_k4_matches_jax(HW, C, n_out, act, dtype):
    """K4's plain version vs the TPU kernel in interpret mode: int8 codes at
    most 1 LSB apart on at most 0.1% of them (the port sums in
    `window_sum`'s order and takes 1/sqrt and 1/(1+exp) where JAX takes
    rsqrt and sigmoid, so a rare value crosses a rounding tie; measured 0 at
    these seeds but one output at (16, 384), 8.1e-5 of its codes)."""
    rng = np.random.default_rng(HW + C + n_out)
    x = (rng.standard_normal((2, HW, C)) * 2 + 0.3).astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    gs, gb = _gn_np(rng, C)
    qp = [_quant_np(rng, C, b, -1.0, 5.0) for b in (8, 6, 8)[:n_out]]
    got = gn_act_quant(_bf16_t(x) if dtype == "bfloat16" else _t(x), _t(gs), _t(gb),
                       [(_t(s), _t(z), b) for s, z, b in qp], act=act)
    want = jfg.gn_act_quant(jnp.asarray(x), jnp.asarray(gs), jnp.asarray(gb),
                            [(jnp.asarray(s), jnp.asarray(z), b) for s, z, b in qp], act=act, interpret=True)
    assert len(got) == len(want) == n_out
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape
        d = np.abs(g.numpy().astype(np.int32) - np.asarray(w).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("dot_dtype,res_dtype", [("bfloat16", "float32"), ("int32", "bfloat16")])
@pytest.mark.parametrize("HW,N", [(64, 128), (64, 256)])
def test_k7_matches_jax(HW, N, dot_dtype, res_dtype):
    """K7's plain version vs the TPU kernel in interpret mode: residual' in
    bf16 within 1 ulp (one rounding of the same f32 sum) and the [B, 2, G]
    sums within 1e-5 relative (f32 sums in another order); the mean and rstd
    `gn_finalize_sums` makes of them agree to 1e-5 (1/sqrt against rsqrt)."""
    rng = np.random.default_rng(HW + N + len(dot_dtype))
    B, H = 2, int(HW ** 0.5)
    if dot_dtype == "bfloat16":
        dot = (rng.standard_normal((B, H, H, N)) * 1.5 + 0.2).astype(ml_dtypes.bfloat16)
        inv_ws, zcbias = np.ones(N, np.float32), np.zeros(N, np.float32)
    else:
        dot = rng.integers(-20000, 20000, (B, H, H, N)).astype(np.int32)
        inv_ws = rng.uniform(5e-5, 2e-4, N).astype(np.float32)
        zcbias = rng.standard_normal(N).astype(np.float32)
    x_res = (rng.standard_normal((B, H, H, N)) * 2 + 0.5).astype(
        ml_dtypes.bfloat16 if res_dtype == "bfloat16" else np.float32)
    tt = lambda a: _bf16_t(a) if a.dtype == ml_dtypes.bfloat16 else _t(a)
    out, sums = epilogue_residual_gn_stats(tt(dot), _t(inv_ws), _t(zcbias), tt(x_res), out_dtype=torch.bfloat16)
    jout, jsums = jfg.epilogue_residual_gn_stats(jnp.asarray(dot), jnp.asarray(inv_ws), jnp.asarray(zcbias),
                                                 jnp.asarray(x_res), out_dtype=jnp.bfloat16, interpret=True)
    assert out.dtype == torch.bfloat16 and tuple(sums.shape) == jsums.shape == (B, 2, 32)
    assert _bf16_ulps(out.float().numpy(), np.asarray(jout).astype(np.float32)).max() <= 1.0
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5)
    mean, rstd = tfg.gn_finalize_sums(sums, HW, N // 32)
    jmean, jrstd = jfg.gn_finalize_sums(jsums, HW, N // 32)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-5)


def _k12_inputs(rng, H, C):
    B = 2
    r = (rng.standard_normal((B, H, H, C)) * 1.5 + 0.2).astype(ml_dtypes.bfloat16)
    tproj = rng.standard_normal((B, C)).astype(np.float32)

    def half():
        s, z, _ = _quant_np(rng, C, 8, -1.0, 5.0)
        sb = (rng.uniform(1e-4, 3e-4, C).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32))
        return (*_gn_np(rng, C), (s, z), _i8(rng, (9 * C, C), -8, 7), sb)

    return (r, tproj, *half(), *half())


@pytest.mark.parametrize("H,C", [(8, 128), (8, 256)])
def test_k12_matches_jax(H, C):
    """K12's plain version vs the TPU kernel in interpret mode, bf16 in and
    out: at least 99% of the elements within 1 bf16 ulp and a small mean
    relative error.  Both keep conv1's output in f32 up to GroupNorm 2 (the
    unfused chain rounds it to bf16 and would miss this bound); a few int8
    codes cross a rounding tie (summation order, 1/sqrt against rsqrt) and
    each moves its 3x3 neighbourhood of conv outputs.  Measured at these
    seeds: 100% within 1 ulp, mean rel err 0 and 2.2e-7."""
    rng = np.random.default_rng(H + C)
    args = _k12_inputs(rng, H, C)
    got = resblock_pallas(_bf16_t(args[0]), *_to_torch(args[1:]))
    want = jrb.resblock_pallas(*_to_jax(args), interpret=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    within = (_bf16_ulps(got, want) <= 1.0).mean()
    assert within >= 0.99 and rel < 1e-3, (rel, within)


@pytest.mark.parametrize("H,C", [(8, 128), (8, 256)])
def test_k12_matches_jax_at_f32(H, C):
    """K12 at a float32 residual in and out, the plain version against the
    TPU kernel in interpret mode.  GN1 sums f32 values (not bf16 ones) in
    the windowed order against JAX's one-hot sums, so an int8 code on a tie
    moves its 3x3 neighbourhood; measured at these seeds: mean rel err at
    most 2.3e-8, at least 99.74% of the elements within 2 f32 ulp (bounded
    at 4x: 9e-8, and at most 1.03% off)."""
    rng = np.random.default_rng(H + C + 1)
    args = list(_k12_inputs(rng, H, C))
    args[0] = args[0].astype(np.float32) + (1e-3 * rng.standard_normal(args[0].shape)).astype(np.float32)
    got = resblock_pallas(_t(args[0]), *_to_torch(args[1:]), out_dtype=torch.float32)
    want = np.asarray(jrb.resblock_pallas(*_to_jax(args), out_dtype=jnp.float32, interpret=True))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    within = (np.abs(got - want) <= 2 * np.finfo(np.float32).eps * np.abs(want)).mean()
    assert within >= 0.9897 and rel < 9e-8, (rel, within)


@pytest.mark.parametrize("ksize", [1, 3])
@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
def test_k1_residual_add_mode(ksize, res_dtype):
    """K1's residual-add epilogue (K3's and K12's last launch) on the CPU:
    res + (acc * inv_ws + zcbias) in f32, at res's dtype, as the TPU
    kernels' `o_ref[...] = (r + out).astype(o_ref.dtype)`."""
    rng = np.random.default_rng(ksize)
    H, Cp, Np = 6, 128, 256
    xp = _t(_i8(rng, (2, H + ksize - 1, H + ksize - 1, Cp), -128, 127))
    gq = _t(_i8(rng, (ksize * ksize * Cp, Np), -8, 7))
    inv_ws, zcbias = _t(rng.uniform(1e-4, 1e-3, Np).astype(np.float32)), _t(rng.standard_normal(Np).astype(np.float32))
    res = _t(rng.standard_normal((2, H, H, Np)).astype(np.float32)).to(res_dtype)
    got = int8_conv(xp, gq, inv_ws, zcbias, ksize=ksize, out_dtype=res_dtype, res=res)
    acc = int8_conv(xp, gq, ksize=ksize)
    assert got.dtype == res_dtype
    assert torch.equal(got, (res.float() + (acc.float() * inv_ws + zcbias)).to(res_dtype))
    with pytest.raises(NotImplementedError):
        int8_conv(xp, gq, inv_ws, zcbias, ksize=ksize, out_dtype=torch.int32, res=res)


SHAPES = [(128, 32, 128), (128, 32, 256), (128, 16, 256), (128, 8, 256), (128, 4, 256), (32, 256, 128),
          (32, 64, 256), (32, 32, 256), (32, 16, 512), (32, 8, 512), (2, 4, 512), (7, 16, 384), (1, 8, 96)]


@pytest.mark.parametrize("B,H,C", SHAPES, ids=[f"B{b}-H{h}-C{c}" for b, h, c in SHAPES])
def test_lever_predicates_match_jax(B, H, C):
    """The routing predicates the port copied from JAX, at the CIFAR-10 and
    church shapes and off the grid."""
    assert tfg.epilogue_residual_gn_stats_fits(H * H, C) == jfg.epilogue_residual_gn_stats_fits(H * H, C)
    assert trb.resblock_pallas_fits(B, H, H, C) == jrb.resblock_pallas_fits(B, H, H, C)
    assert tpc.conv3_pallas_wins(B, H, H, C, C) == jpc.conv3_pallas_wins(B, H, H, C, C)
    assert tpc.conv3_pallas_wins(B, H, H, 512, 256) == jpc.conv3_pallas_wins(B, H, H, 512, 256)
    assert tpc.conv3_pallas_fits(B, H, H, C, C) == jpc.conv3_pallas_fits(B, H, H, C, C)


# ---------------------------------------------------------------------------
# routing: plain versions only for CPU tensors, no silent fallback
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    """Each wrapper runs its plain version on CPU tensors (bit-identical to
    calling it with plain=True) and counts no launch."""
    rng = np.random.default_rng(9)
    counters = (int8_conv, epilogue_gn_swish_quant_whole, epilogue_gn_swish_quant_blocked, fused_attention_block,
                gn_act_quant, epilogue_residual_gn_stats, resblock_pallas)
    before = tuple(f.launches for f in counters)
    xp, gq = _t(_i8(rng, (1, 6, 6, 128))), _t(_i8(rng, (9 * 128, 128), -8, 7))
    assert torch.equal(int8_conv(xp, gq), int8_conv(xp, gq, plain=True))
    k2 = [_t(a) for a in _k2_inputs(rng, 16, 256, "int32")]
    assert torch.equal(epilogue_gn_swish_quant(*k2, 8), epilogue_gn_swish_quant(*k2, 8, plain=True))
    k6 = [_t(a) for a in _k2_inputs(rng, 9216, 128, "int32")]  # 96^2 * 128 * 5 B: over the budget
    assert epilogue_route(k6[0].shape, k6[0].dtype) == "K6"
    assert torch.equal(epilogue_gn_swish_quant(*k6, 8), epilogue_gn_swish_quant_blocked(*k6, 8, plain=True))
    x, *rest = _k3_inputs(rng, 16, 256)
    xt = _t(x.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(fused_attention_block(xt, *_to_torch(rest), scale=1 / 16),
                       fused_attention_block(xt, *_to_torch(rest), scale=1 / 16, plain=True))
    k4 = (xt, _t(rest[0]), _t(rest[1]), _to_torch(rest[2]))
    assert all(torch.equal(a, b) for a, b in zip(gn_act_quant(*k4, act="none"),
                                                 gn_act_quant(*k4, act="none", plain=True)))
    k7 = (k2[0], k2[1], k2[2], torch.randn(k2[0].shape, generator=torch.Generator().manual_seed(0)))
    assert all(torch.equal(a, b) for a, b in zip(epilogue_residual_gn_stats(*k7),
                                                 epilogue_residual_gn_stats(*k7, plain=True)))
    r, *k12 = _k12_inputs(rng, 4, 128)
    assert torch.equal(resblock_pallas(_bf16_t(r), *_to_torch(k12)),
                       resblock_pallas(_bf16_t(r), *_to_torch(k12), plain=True))
    assert tuple(f.launches for f in counters) == before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building the kernels raises; nothing is skipped or logged away."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_kernel_inputs_must_be_on_one_cuda_device():
    with pytest.raises(ValueError):
        _build.require_cuda("int8_conv", torch.zeros(4, dtype=torch.int8))
