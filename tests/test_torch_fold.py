"""PyTorch port vs the JAX package: the per-step weight fold
(attentiondm_tpu_torch.ops.quant_conv, quant.int8_runtime, and
quant.int8_serving.prepare_serving_runtime / gather_step).

qstates come from a seeded numpy generator (no calibration here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.ops import quant_conv as jqc
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant.int8_runtime import _fold_all_steps as j_fold_all_steps
from attentiondm_tpu.quant.int8_serving import prepare_serving_runtime as j_prepare
from attentiondm_tpu.quant.state import ActQuantState as JActQuantState
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params
from attentiondm_tpu_torch.ops import quant_conv as qc
from attentiondm_tpu_torch.quant.int8_runtime import _fold_all_steps
from attentiondm_tpu_torch.quant.int8_serving import ServingLayer, gather_step, prepare_serving_runtime, runtime_nbytes
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
from attentiondm_tpu_torch.quant.state import from_jax_qstates


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
SHAPES = [(3, 128, 256), (3, 256, 256), (1, 384, 128), (3, 128, 3)]  # (ksize, cin, cout)


def _kernel(rng, k, ci, co):
    return (rng.uniform(-1, 1, (k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)


def _ranges(rng, S, G, C, stage1=True):
    """Random group ranges; logits constant over groups as stage 1 leaves
    them (softmax exactly 1/G), or random as stage 2 would make them."""
    gr = np.stack([-rng.uniform(0.3, 4, (S, G)), rng.uniform(0.5, 6, (S, G))], -1).astype(np.float32)
    if stage1:
        al = np.full((S, G, C), rng.uniform(-1, 1), np.float32)
    else:
        al = (rng.standard_normal((S, G, C)) * 0.7).astype(np.float32)
    return gr, al


def _mse(kernel, scale, shrink, w_bit):
    """Float64 reconstruction error per out channel of one shrink choice."""
    g = kernel.astype(np.float64) / scale.astype(np.float64).reshape(1, 1, -1, 1)
    n = 2 ** (w_bit - 1)
    ws = (n - 1) / (np.maximum(np.abs(g).max(axis=(0, 1, 2)), 1e-8) * shrink)
    q = np.clip(np.round(ws * g), -n, n - 1)
    return ((q / ws - g) ** 2).sum(axis=(0, 1, 2))


@pytest.mark.parametrize("k,ci,co", SHAPES)
def test_fold_shrink_search_matches_jax(k, ci, co):
    """Same shrink per channel, except where two candidates tie to float error."""
    rng = np.random.default_rng(k * ci + co)
    kernel = _kernel(rng, k, ci, co)
    scale = rng.uniform(5, 60, ci).astype(np.float32)
    got = qc.fold_shrink_search(torch.tensor(kernel), torch.tensor(scale), 4, True).numpy()
    want = np.asarray(jqc.fold_shrink_search(jnp.asarray(kernel), jnp.asarray(scale), 4, True))
    diff = got != want
    assert diff.mean() < 0.05
    if diff.any():
        e_got = _mse(kernel, scale, got, 4)[diff]
        e_want = _mse(kernel, scale, want, 4)[diff]
        np.testing.assert_allclose(e_got, e_want, rtol=1e-6)


@pytest.mark.parametrize("k,ci,co", SHAPES)
@pytest.mark.parametrize("symmetric", [True, False])
def test_fold_weights_int8_and_zcorr_match_jax(k, ci, co, symmetric):
    rng = np.random.default_rng(k + ci + co)
    kernel = _kernel(rng, k, ci, co)
    scale = rng.uniform(5, 60, ci).astype(np.float32)
    zp = np.round(rng.uniform(-60, 60, ci)).astype(np.float32)
    shrink = rng.choice(np.asarray(qc.WEIGHT_MSE_SHRINKS, np.float32), co)
    got = qc.fold_weights_int8(torch.tensor(kernel), torch.tensor(scale), 4, symmetric, torch.tensor(shrink))
    want = jqc.fold_weights_int8(jnp.asarray(kernel), jnp.asarray(scale), 4, symmetric, shrink=jnp.asarray(shrink))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # gq: integers
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    zc = qc.zcorr_from_fold(got[3], torch.tensor(zp), k, ci).numpy()
    zc_j = np.asarray(jqc.zcorr_from_fold(want[3], jnp.asarray(zp), k, ci))
    # f32 dot of K = k*k*Cp terms in another order; atol for sums near 0
    np.testing.assert_allclose(zc, zc_j, rtol=1e-5, atol=1e-5 * np.abs(zc_j).max())


@pytest.mark.parametrize("k,ci,co", SHAPES[:3])
@pytest.mark.parametrize("stage1", [True, False], ids=["stage1_logits", "random_logits"])
def test_fold_all_steps_matches_jax(k, ci, co, stage1):
    """Symmetric, non-rank-1 fold of every step: gq exact, scales to 1e-6.
    With random logits the two softmaxes' exp differ in the last bit, which
    moves a rare product across a rounding tie: <= 1e-5 of gq off by 1."""
    rng = np.random.default_rng(7 * k + ci)
    kernel = _kernel(rng, k, ci, co)
    gr, al = _ranges(rng, 3, 8, ci, stage1)
    got = _fold_all_steps(torch.tensor(kernel), torch.tensor(gr), torch.tensor(al), 8, 4)
    want = j_fold_all_steps(jnp.asarray(kernel), jnp.asarray(gr), jnp.asarray(al), 8, 4, True)
    names = ("gq", "ws", "wzp", "zcorr", "act_scale", "act_zp")
    flipped = (got[0].numpy() != np.asarray(want[0])).any(axis=1)  # [S, Np]: a gq moved
    for name, a, b in zip(names, got, want):
        a, b = a.numpy(), np.asarray(b)
        if name == "gq" and not stage1:
            d = np.abs(a.astype(np.int32) - b)
            assert d.max() <= 1 and (d > 0).mean() <= 1e-5, (d.max(), (d > 0).mean())
        elif name == "zcorr" and not stage1:  # a moved gq moves its column's zcorr
            np.testing.assert_allclose(a[~flipped], b[~flipped], rtol=1e-5, atol=1e-5 * np.abs(b).max())
        elif name in ("gq", "act_zp", "wzp"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            tol = 1e-5 if name == "zcorr" else 1e-6
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max(), err_msg=name)


@pytest.fixture(scope="module")
def toy_fold():
    """JAX's serving fold of the toy UNet under seeded random qstates."""
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    rng = np.random.default_rng(11)
    states = {}
    for name, st in jq.init_state(2).items():
        gr, al = _ranges(rng, 2, st.group_ranges.shape[1], st.alpha_logits.shape[2])
        states[name] = dict(init_range=np.asarray(st.init_range), act_min=np.asarray(st.act_min),
                            act_max=np.asarray(st.act_max), group_ranges=gr, alpha_logits=al)
    jqs = {k: JActQuantState(**{f: jnp.asarray(v) for f, v in d.items()}) for k, d in states.items()}
    jrt = j_prepare(jq, jparams, jqs)
    q = QuantizedUNet.create(UNetConfig(**TOY), 4, 8)
    rt = prepare_serving_runtime(q, from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                                 from_jax_qstates(states, device="cpu"))
    return jrt, rt


def test_prepare_serving_runtime_matches_jax(toy_fold):
    jrt, rt = toy_fold
    assert rt.keys() == jrt.keys() and "conv_in" not in rt  # 3 input channels: not eligible
    for name, lay in rt.items():
        ref = jrt[name]
        np.testing.assert_array_equal(lay.gq.numpy(), np.asarray(ref.gq), err_msg=name)
        for f in ("inv_ws", "act_scale", "act_zp"):
            np.testing.assert_allclose(getattr(lay, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-6,
                                       err_msg=f"{name}.{f}")
        zc = np.asarray(ref.zcbias)
        np.testing.assert_allclose(lay.zcbias.numpy(), zc, rtol=1e-5, atol=1e-5 * np.abs(zc).max(),
                                   err_msg=f"{name}.zcbias")


def test_gather_step_slices_one_step(toy_fold):
    _, rt = toy_fold
    for i in (0, 1):
        one = gather_step(rt, i)
        for name, lay in one.items():
            assert torch.equal(lay.gq, rt[name].gq[i]) and torch.equal(lay.zcbias, rt[name].zcbias[i])
            assert lay.gq.dtype == torch.int8 and lay.gq.shape[0] % 128 == 0 and lay.gq.shape[1] % 128 == 0


def test_gq_is_a_view_of_the_one_copy(toy_fold):
    """The fold is held once, K-major (`gqt`): `gq` is a view of its storage,
    equal to JAX's fold layout, in the runtime and in every step's slice."""
    jrt, rt = toy_fold
    for name, lay in rt.items():
        assert lay.gq.untyped_storage().data_ptr() == lay.gqt.untyped_storage().data_ptr(), name
        assert lay.gqt.is_contiguous() and not lay.gq.is_contiguous(), name
        np.testing.assert_array_equal(lay.gq.numpy(), np.asarray(jrt[name].gq), err_msg=name)
    for i in (0, 1):
        for name, lay in gather_step(rt, i).items():
            assert lay.gq.untyped_storage().data_ptr() == rt[name].gqt.untyped_storage().data_ptr(), name
            np.testing.assert_array_equal(lay.gq.numpy(), np.asarray(jrt[name].gq)[i], err_msg=name)


def test_runtime_nbytes_counts_the_fold_once(toy_fold):
    """`runtime_nbytes` counts each storage once: the weights' bytes once
    (where a second layout beside them doubled them), and the vectors."""
    _, rt = toy_fold
    weights = sum(lay.gqt.numel() for lay in rt.values())
    vectors = sum(a.numel() * a.element_size() for lay in rt.values()
                  for a in (lay.inv_ws, lay.zcbias, lay.act_scale, lay.act_zp))
    held = runtime_nbytes(rt)
    assert held == weights + vectors
    two_copies = 2 * weights + vectors
    assert held < 0.51 * two_copies + vectors  # about half: the weights are most of the fold
    # a layer made from `gq` keeps no copy of it
    gq = rt[next(iter(rt))].gq.contiguous()
    lay = ServingLayer(gq, *(torch.zeros(gq.shape[0], gq.shape[-1]) for _ in range(4)))
    assert torch.equal(lay.gq, gq) and lay.gq.untyped_storage().data_ptr() == lay.gqt.untyped_storage().data_ptr()


# rank1, pack_int4 and steps (step_chunk's fold) are ported: tests/test_torch_imagenet64.py
# the weight extras are ported: tests/test_torch_weight_extras.py
@pytest.mark.parametrize("kw", [dict(symmetric=False)], ids=["asymmetric"])
def test_unported_fold_options_raise(kw):
    """The serving fold is symmetric: an asymmetric one raises ValueError,
    naming the interception runtime that serves it (JAX refuses it too)."""
    q = QuantizedUNet.create(UNetConfig(**TOY), 4, 8)
    with pytest.raises(ValueError, match="int8_runtime"):
        prepare_serving_runtime(q, {}, {}, **kw)
