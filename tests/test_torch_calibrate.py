"""PyTorch port vs the JAX package: quantization primitives, bit policy and
stage-1 range calibration (attentiondm_tpu_torch.quant)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion import ddim_sample as j_ddim_sample
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import primitives as jprim
from attentiondm_tpu.quant import state as jstate
from attentiondm_tpu.quant.calibrate import _calibrate_one_conv as j_calibrate_one_conv
from attentiondm_tpu.quant.groupwise import groupwise_ranges as j_groupwise_ranges
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params
from attentiondm_tpu_torch.quant import primitives, state
from attentiondm_tpu_torch.quant.calibrate import _calibrate_one_conv, calibrate_ranges
from attentiondm_tpu_torch.quant.groupwise import groupwise_ranges
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
from attentiondm_tpu_torch.quant.state import ActQuantConfig, from_jax_qstates


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
SEQ = [0, 500]
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def calibrated():
    """Stage-1 calibration on the JAX FP teacher trajectory: JAX's own
    calibration forward, recording each conv's input and update, and
    the port's `calibrate_ranges` on the same trajectory."""
    from attentiondm_tpu.models.unet import conv2d as j_conv2d

    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)).astype(np.float32)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    _, traj, _ = j_ddim_sample(lambda xt, t, i: j_unet_apply(jparams, jcfg, xt, t), jnp.asarray(x), SEQ,
                               betas, keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x)[None], traj[:-1]], axis=0)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs0 = jq.init_state(len(SEQ))
    records = []  # (step, name, conv input, JAX update): calibrate_ranges_step's conv_apply
    one_conv = jax.jit(j_calibrate_one_conv, static_argnums=(2, 3, 4))
    t_rev = np.asarray(SEQ, np.float32)[::-1]
    for s in range(len(SEQ)):
        def conv_apply(name, xin, p, *, stride=1, padding="SAME", s=s):
            upd, xq = one_conv(xin, jqs0[name], jq.policy[name], s, True)
            records.append((s, name, np.asarray(xin), {k: np.asarray(v) for k, v in upd.items()}))
            return j_conv2d(xq, p, stride=stride, padding=padding)

        j_unet_apply(jparams, jcfg, xs_in[s], jnp.full((2,), t_rev[s]), conv_apply=conv_apply)
    q = QuantizedUNet.create(UNetConfig(**TOY), 4, 8)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    qs = calibrate_ranges(q, params, q.init_state(len(SEQ), "cpu"), _t(xs_in), SEQ)
    return q, records, qs


def test_calibrate_ranges_matches_jax_on_its_inputs(calibrated):
    """Every conv at every step, given the input JAX's calibration forward
    gave it, gets JAX's update."""
    q, records, _ = calibrated
    assert len(records) == 2 * len(q.policy)
    st0 = q.init_state(len(SEQ), "cpu")
    for s, name, xin, want in records:
        got, _ = _calibrate_one_conv(torch.tensor(xin), st0[name], q.policy[name], s, True)
        for f in FIELDS:
            if f == "alpha_logits":  # stage 1 carries the logits through untouched
                np.testing.assert_array_equal(got[f].numpy(), want[f], err_msg=name)
            else:  # min / max / bucket picks of the same f32 activations (measured 1.2e-7)
                np.testing.assert_allclose(got[f].numpy(), want[f], rtol=5e-7, err_msg=f"{s} {name}.{f}")


def test_calibrate_ranges_end_to_end(calibrated):
    """The port's own calibration forward: every conv calibrated at every
    step, logits untouched, each range floor one of the LAPQ candidates and
    covered by the snapped ranges.  (Bit-level agreement with JAX's whole
    forward is not expected: f32 conv summation order flips a few fake-quant
    codes, and the propagated codes move later layers' ranges; ROADMAP
    Queue 3.)"""
    q, records, qs = calibrated
    assert qs.keys() == q.policy.keys()
    grid = np.array([1.0 - 0.1 * a for a in range(9)], np.float32)
    for name, st in qs.items():
        np.testing.assert_array_equal(st.alpha_logits.numpy(), np.full(st.alpha_logits.shape, 0.01, np.float32))
        for s in range(len(SEQ)):
            lo, hi = st.init_range[s].numpy()
            ratio = np.float32(lo / -4.0)
            assert np.isclose(grid, ratio, rtol=1e-6).any(), (name, lo, hi)
            assert np.isclose(hi / 6.0, ratio, rtol=1e-6), (name, lo, hi)
            assert (st.act_min[s] <= lo + 1e-6).all() and (st.act_max[s] >= hi - 1e-6).all(), name
            assert (st.group_ranges[s, :, 0] < st.group_ranges[s, :, 1]).all(), name
    # the first conv sees the same input on both sides, so it agrees exactly
    first = [r for r in records if r[1] == "conv_in"]
    for s, _name, _xin, want in first:
        for f in FIELDS:
            np.testing.assert_allclose(getattr(qs["conv_in"], f)[s].numpy(), want[f], rtol=1e-6)


def test_from_jax_qstates_round_trip():
    jq = JQuantizedUNet.create(JConfig(**TOY), 4, 8)
    jqs = jq.init_state(3)
    qs = from_jax_qstates({k: {f: np.asarray(getattr(v, f)) for f in FIELDS} for k, v in jqs.items()})
    ref = QuantizedUNet.create(UNetConfig(**TOY), 4, 8).init_state(3, "cpu")
    for name in qs:
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(qs[name], f).numpy(), np.asarray(getattr(jqs[name], f)))
            np.testing.assert_array_equal(getattr(ref[name], f).numpy(), np.asarray(getattr(jqs[name], f)))


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("a_bit", [8, 6])
def test_calibrate_one_conv_matches_jax(first, a_bit):
    rng = np.random.default_rng(a_bit)
    x = (rng.standard_normal((2, 4, 4, 128)) * rng.uniform(0.2, 5, 128)).astype(np.float32)
    S, G, C = 3, 8, 128
    cfg = ActQuantConfig(w_bit=4, a_bit=a_bit)
    jst = jstate.init_act_quant_state(S, C, jstate.ActQuantConfig(w_bit=4, a_bit=a_bit))
    st = state.init_act_quant_state(S, C, cfg, "cpu")
    jupd, jxq = j_calibrate_one_conv(jnp.asarray(x), jst, jstate.ActQuantConfig(w_bit=4, a_bit=a_bit), 1, first)
    upd, xq = _calibrate_one_conv(torch.from_numpy(x), st, cfg, 1, first)
    for k in jupd:
        np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(xq.numpy(), np.asarray(jxq), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("maxmin", ["max", "min"])
@pytest.mark.parametrize("case", ["random", "edges"])
def test_groupwise_ranges_matches_jax(maxmin, case):
    rng = np.random.default_rng(3)
    if case == "random":
        x = (rng.standard_normal(256) * 3).astype(np.float32)
    else:  # values on the bucket edges: the later bucket wins, empty buckets take their edge
        x = np.array([0.0, 1.0, 2.0, 2.0, 4.0, 8.0], np.float32)
    snapped, vals = groupwise_ranges(torch.from_numpy(x), 8, maxmin)
    jsnapped, jvals = j_groupwise_ranges(jnp.asarray(x), 8, maxmin)
    np.testing.assert_array_equal(snapped.numpy(), np.asarray(jsnapped))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_primitives_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 4, 4, 64)) * 3).astype(np.float32)
    lo = -rng.uniform(0.5, 4, 64).astype(np.float32)
    hi = rng.uniform(0.5, 6, 64).astype(np.float32)
    for bits in (4, 6, 8):
        np.testing.assert_array_equal(
            primitives.fake_quant(torch.from_numpy(x), bits, _t(lo), _t(hi)).numpy(),
            np.asarray(jprim.fake_quant(jnp.asarray(x), bits, jnp.asarray(lo), jnp.asarray(hi))))
    y = x + rng.standard_normal(x.shape).astype(np.float32) * 0.1
    for p, red in ((2.0, "none"), (0.5, "all")):
        np.testing.assert_allclose(primitives.lp_loss(_t(x), _t(y), p, red).item(),
                                   float(jprim.lp_loss(jnp.asarray(x), jnp.asarray(y), p, red)), rtol=1e-6)
    gr = np.stack([-rng.uniform(0.5, 4, 8), rng.uniform(0.5, 6, 8)], 1).astype(np.float32)
    al = (rng.standard_normal((8, 64)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(
        state.quantize_activation_mixture(_t(x), _t(gr), _t(al), 8).numpy(),
        np.asarray(jstate.quantize_activation_mixture(jnp.asarray(x), jnp.asarray(gr), jnp.asarray(al), 8)),
        rtol=1e-5, atol=1e-5)  # softmax weights: exp/sum order


@pytest.mark.parametrize("cfg_kw", [TOY, {}], ids=["toy", "cifar10"])
def test_bit_policy_matches_jax(cfg_kw):
    """W4A8: k projections get w4/a6, v 4 groups, everything else w4/a8/8."""
    got = QuantizedUNet.create(UNetConfig(**cfg_kw), 4, 8).policy
    want = JQuantizedUNet.create(JConfig(**cfg_kw), 4, 8).policy
    assert {k: (v.w_bit, v.a_bit, v.group_num) for k, v in got.items()} == \
        {k: (v.w_bit, v.a_bit, v.group_num) for k, v in want.items()}
    assert got["mid.attn_1.k"].a_bit == 6 and got["mid.attn_1.v"].group_num == 4


def test_unported_calibration_options_raise(calibrated):
    q = QuantizedUNet.create(UNetConfig(**TOY), 4, 8)
    xs = torch.zeros(2, 1, 8, 8, 3)
    for kw in (dict(return_attn_ranges=True), dict(assignment_init=True)):
        with pytest.raises(NotImplementedError):
            calibrate_ranges(q, {}, {}, xs, SEQ, **kw)
