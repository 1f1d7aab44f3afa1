"""PyTorch port vs the JAX package: the W4A8 fake-quant model
(attentiondm_tpu_torch.quant.qunet, the weight side of quant.state, the rest
of quant.primitives and models.unet.cast_params).

The JAX side runs once per module: weight states, quantized params, one
forward per conv-interceptor mode and a 2-step fake-quant DDIM sample, on a
toy UNet under seeded random activation states."""
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
from attentiondm_tpu.models.unet import cast_params as j_cast_params
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import primitives as jprim
from attentiondm_tpu.quant import qunet as jqunet
from attentiondm_tpu.quant.state import ActQuantState as JActQuantState
from attentiondm_tpu.quant.state import make_weight_quant_state as j_make_wstate
from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, cast_params, from_jax_params, iter_conv_layers, lookup
from attentiondm_tpu_torch.quant import primitives as prim
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet, make_quant_conv_apply, make_weight_states
from attentiondm_tpu_torch.quant.state import from_jax_qstates, make_weight_quant_state


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
MODES = ("infer", "mixture", "collect", "off")
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _states(jq, rng):
    """Seeded activation states: random group ranges, and logits constant over
    the groups as stage 1 leaves them.  (Random logits would put the two
    softmaxes' last-bit `exp` difference into every scale, and on this toy's
    random weights the flipped codes carry a few percent to eps: ROADMAP
    Queue 3's softmax parity gap.)"""
    out = {}
    for name, st in jq.init_state(len(SEQ)).items():
        S, G, C = st.alpha_logits.shape
        gr = np.stack([-rng.uniform(0.5, 4, (S, G)), rng.uniform(0.5, 6, (S, G))], -1).astype(np.float32)
        out[name] = dict(init_range=np.asarray(st.init_range), act_min=np.asarray(st.act_min),
                         act_max=np.asarray(st.act_max), group_ranges=gr,
                         alpha_logits=np.full((S, G, C), rng.uniform(-1, 1), np.float32))
    return out


@pytest.fixture(scope="module")
def chain():
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    rng = np.random.default_rng(0)
    states = _states(jq, rng)
    jqs = {k: JActQuantState(**{f: jnp.asarray(v) for f, v in d.items()}) for k, d in states.items()}
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.full((2,), 500.0, np.float32)
    jqp, jws = jq.prepare_params(jparams)
    eps, sites, collected = {}, {}, {}
    for mode in MODES:
        ca = jqunet.make_quant_conv_apply(jqs, jq.policy, 1, mode=mode, collect=collected if mode == "collect" else None)
        sites[mode] = []

        def record(name, xin, p, *, stride=1, padding="SAME", ca=ca, rec=sites[mode]):
            out = ca(name, xin, p, stride=stride, padding=padding)
            rec.append((name, np.asarray(xin), np.asarray(out), stride, padding))
            return out

        eps[mode] = np.asarray(j_unet_apply(jqp, jcfg, jnp.asarray(x), jnp.asarray(t), conv_apply=record))
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    sample = j_ddim_sample(jq.model_fn(jqp, jqs), jnp.asarray(x), SEQ, betas)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return dict(
        params=from_jax_params(np_tree, device="cpu"), qparams=jax.tree_util.tree_map(np.asarray, jqp),
        wstates={k: (np.asarray(v.w_min), np.asarray(v.w_max)) for k, v in jws.items()},
        qstates=from_jax_qstates(states, device="cpu"), x=x, t=t, eps=eps, sites=sites, sample=np.asarray(sample),
        collected={k: (np.asarray(a), np.asarray(b)) for k, (a, b) in collected.items()}, np_params=np_tree,
    )


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8)


# --- primitives -----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ste_round", "ste_floor"])
def test_straight_through_estimators_match_jax(name):
    """Forward round (half to even) / floor; backward the gradient unchanged."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-5, 5, 64), np.arange(-3.5, 4.0, 0.5)]).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jfn = getattr(jprim, name)
    want_y = np.asarray(jfn(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v) * jnp.asarray(w)))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = getattr(prim, name)(xt)
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)


@pytest.mark.parametrize("ste", [True, False])
def test_fake_quant_values_and_gradients_match_jax(ste):
    """Values equal; with `ste` the gradient passes through the rounding, is
    cut outside the range and halved on its bounds, as `jnp.clip`'s; without,
    it is zero (round has none)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-6, 6, (4, 5, 16)).astype(np.float32)
    lo, hi = -rng.uniform(1, 3, 16).astype(np.float32), rng.uniform(1, 3, 16).astype(np.float32)
    x[0, 0] = lo  # on the bounds: the clip's tie
    x[0, 1] = hi
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jf(v):
        return jnp.sum(jprim.fake_quant(v, 8, jnp.asarray(lo), jnp.asarray(hi), ste=ste) * jnp.asarray(w))

    want_y = np.asarray(jprim.fake_quant(jnp.asarray(x), 8, jnp.asarray(lo), jnp.asarray(hi), ste=ste))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = prim.fake_quant(xt, 8, torch.tensor(lo), torch.tensor(hi), ste=ste)
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)
    assert (not ste) or (want_g == 0.5 * w).any()  # a bound was hit


def test_quantize_dequantize_int_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-4, 4, (3, 7, 32)).astype(np.float32)
    scale = rng.uniform(10, 40, 32).astype(np.float32)
    zp = np.round(rng.uniform(-30, 30, 32)).astype(np.float32)
    q = prim.quantize_int(torch.tensor(x), torch.tensor(scale), torch.tensor(zp), 8)
    jq = jprim.quantize_int(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zp), 8)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(prim.dequantize_int(q, torch.tensor(scale), torch.tensor(zp)).numpy(),
                                  np.asarray(jprim.dequantize_int(jq, jnp.asarray(scale), jnp.asarray(zp))))


@pytest.mark.parametrize("percentile", [0.9999, 0.99])
def test_percentile_range_matches_jax(percentile):
    x = np.random.default_rng(4).standard_normal(20000).astype(np.float32)
    lo, hi = prim.percentile_range(torch.tensor(x), percentile)
    jlo, jhi = jprim.percentile_range(jnp.asarray(x), percentile)
    # both interpolate linearly between the two nearest order statistics, in another float order
    np.testing.assert_allclose([float(lo), float(hi)], [float(jlo), float(jhi)], rtol=1e-5)


def test_cast_params_matches_jax(chain):
    got = cast_params(chain["params"], torch.bfloat16)
    want = j_cast_params(jax.tree_util.tree_map(jnp.asarray, chain["np_params"]), jnp.bfloat16)
    a, b = lookup(got, "down.0.block.0.conv1")["kernel"], lookup(want, "down.0.block.0.conv1")["kernel"]
    assert a.dtype == torch.bfloat16
    np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


# --- weight states and quantized params --------------------------------------------------------------------------


@pytest.mark.parametrize("w_bit", [None, 4, 8])
def test_make_weight_quant_state_matches_jax(w_bit):
    """Ranges equal to the bit (JAX searches the shrink in numpy on the host,
    the port in torch; both sum each channel's error in float32)."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((3, 3, 128, 96)) * 0.05).astype(np.float32)
    w[..., :4] *= 20  # a few heavy-tailed channels: the coarse shrinks win there
    got = make_weight_quant_state(torch.tensor(w), w_bit)
    want = j_make_wstate(jnp.asarray(w), w_bit)
    np.testing.assert_array_equal(got.w_min.numpy(), np.asarray(want.w_min))
    np.testing.assert_array_equal(got.w_max.numpy(), np.asarray(want.w_max))


def test_weight_states_and_quantized_params_match_jax(chain):
    """`prepare_params`: every conv's shrink-searched ranges and fake-quantized
    kernel equal JAX's; the other leaves are the float params."""
    cfg, q = _port()
    qp, ws = q.prepare_params(chain["params"])
    assert set(ws) == set(chain["wstates"]) == {n for n, _c, _k in iter_conv_layers(cfg)}
    for name, (w_min, w_max) in chain["wstates"].items():
        np.testing.assert_array_equal(ws[name].w_min.numpy(), w_min, err_msg=name)
        np.testing.assert_array_equal(ws[name].w_max.numpy(), w_max, err_msg=name)
        want = lookup(chain["qparams"], name)["kernel"]
        np.testing.assert_array_equal(lookup(qp, name)["kernel"].numpy(), want, err_msg=name)
    assert lookup(qp, "temb.dense0")["kernel"] is lookup(chain["params"], "temb.dense0")["kernel"]
    # the input tree is not changed
    np.testing.assert_array_equal(lookup(chain["params"], "conv_in")["kernel"].numpy(),
                                  lookup(chain["np_params"], "conv_in")["kernel"])
    assert make_weight_states(chain["params"], cfg)["conv_in"].w_min.shape == (128,)


# --- the conv interceptor and the model ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_conv_apply_modes_match_jax(chain, mode):
    """Each conv of the fake-quant model's forward (step 1, JAX's quantized
    params) given the input JAX's forward gave it: within 1e-5 mean relative
    of JAX's output (measured at most 5e-7: float32 convs in another order).
    `collect` records JAX's per-channel input ranges."""
    cfg, q = _port()
    qp = from_jax_params(chain["qparams"], device="cpu")
    collected = {}
    ca = make_quant_conv_apply(chain["qstates"], q.policy, 1, mode=mode, collect=collected)
    assert len(chain["sites"][mode]) == len(list(iter_conv_layers(cfg)))
    for name, x, want, stride, padding in chain["sites"][mode]:
        got = ca(name, torch.tensor(x), lookup(qp, name), stride=stride, padding=padding)
        assert _rel(got.numpy(), want) < 1e-5, name
    if mode == "collect":
        assert set(collected) == set(chain["collected"])
        for name, (lo, hi) in chain["collected"].items():
            np.testing.assert_array_equal(collected[name][0].numpy(), lo, err_msg=name)
            np.testing.assert_array_equal(collected[name][1].numpy(), hi, err_msg=name)
    else:
        assert not collected


@pytest.mark.parametrize("mode", MODES)
def test_fake_quant_forward_matches_jax(chain, mode):
    """The whole forward per mode.  Without quantization (off, collect) the
    two agree to float order (measured 2.1e-6).  Quantized, the last-bit
    differences of the float convs put one activation code on the other side
    of a rounding tie in the middle block, and on this toy's random weights
    the flips multiply through the later quantizers (at up.0's attention a
    third of the codes differ): measured 2.6e-2 (infer) and 1.1e-2 (mixture)
    mean relative.  Held to a gross-fault bound; the per-conv test above is
    the exact one."""
    cfg, q = _port()
    qp = from_jax_params(chain["qparams"], device="cpu")
    eps = q.apply(qp, chain["qstates"], torch.tensor(chain["x"]), torch.tensor(chain["t"]), 1,
                  mode="off" if mode == "collect" else mode)
    assert torch.isfinite(eps).all()
    assert _rel(eps.numpy(), chain["eps"][mode]) < (1e-5 if mode in ("off", "collect") else 5e-2)


def test_fake_quant_ddim_sample_matches_jax(chain):
    """`QuantizedUNet.model_fn` (mode infer) through the 2-step DDIM sampler,
    from the port's own `prepare_params`: measured 5.7e-3 mean relative (the
    code flips of the forward above)."""
    cfg, q = _port()
    qp, _ = q.prepare_params(chain["params"])
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas
    out = ddim_sample(q.model_fn(qp, chain["qstates"]), torch.tensor(chain["x"]), SEQ, betas)
    assert torch.isfinite(out).all()
    assert _rel(out.numpy(), chain["sample"]) < 2e-2


@pytest.mark.parametrize("call", ["prepare_params", "apply", "model_fn"])
def test_unported_fake_quant_options_raise(chain, call):
    """`compute_dtype` is taken by all three calls (it raised until the
    runner's bf16 path was ported; its parity with JAX is
    tests/test_torch_compute_dtype.py): bf16 params, a float32 eps; a mode
    the interceptor does not define still raises ValueError.  Mode "int8"
    is ported: tests/test_torch_int8_runtime.py."""
    cfg, q = _port()
    x, t = torch.tensor(chain["x"]), torch.tensor(chain["t"])
    qp, _ = q.prepare_params(chain["params"], compute_dtype=torch.bfloat16)
    assert qp["conv_in"]["kernel"].dtype == torch.bfloat16
    if call == "prepare_params":
        return
    if call == "apply":
        eps = q.apply(qp, chain["qstates"], x, t, 0, compute_dtype=torch.bfloat16)
    else:
        eps = q.model_fn(qp, chain["qstates"], compute_dtype=torch.bfloat16)(x, t, 0)
    assert eps.dtype == torch.float32 and torch.isfinite(eps).all()
    with pytest.raises(ValueError):
        q.apply(qp, chain["qstates"], x, t, 0, mode="fast", compute_dtype=torch.bfloat16)
