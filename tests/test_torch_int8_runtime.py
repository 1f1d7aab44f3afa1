"""PyTorch port vs the JAX package: the interception runtime
(`quant/int8_runtime.py`: `_fold_all_steps` symmetric and asymmetric, with
and without the MSE shrink search, `prepare_int8_runtime`,
`make_int8_conv_apply`, `int8_model_fn`), its int8 convs
(`ops/quant_conv.quantized_conv2d_int8_prefolded` and
`quantized_conv2d_int8`, whose products are K13 `_conv3x3_int8_dot` and K5
`int8_matmul`, K1's int32 modes in the port) and `qunet` mode "int8".

The same numpy inputs go to both; JAX's Pallas kernels run in interpret
mode.  The toy is tests/test_torch_serving.py's, at W4A8, with activation
ranges made from a seed (tests/test_torch_f32_stream.py's `_seeded_states`):
JAX's fold of them is held against the port's, and JAX's fold is handed to
the port (`from_jax_int8_runtime`) for the sampler, so a difference there is
the forward's own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion import ddim_sample as j_ddim_sample
from attentiondm_tpu.ops import quant_conv as jqc
from attentiondm_tpu.quant import int8_runtime as jir
from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import from_jax_params, unet_apply
from attentiondm_tpu_torch.ops import quant_conv as qc
from attentiondm_tpu_torch.quant import int8_runtime as ir
from attentiondm_tpu_torch.quant.state import mixed_ranges
from test_torch_f32_stream import SEQ, TOY, _inputs, _model, _rel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jnode(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return tree


SYMMETRY = {"symmetric": True, "asymmetric": False}


@pytest.fixture(scope="module")
def chain():
    """The toy on both sides; JAX's interception runtime (symmetric and
    asymmetric folds) and its 2-step DDIM sample through `int8_model_fn`
    with each, and one `qunet.apply(mode="int8")` forward."""
    m = _model(TOY, 0)
    x, t = _inputs()
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    jrt, sample = {}, {}
    for name, sym in SYMMETRY.items():
        jrt[name] = jir.prepare_int8_runtime(m["jq"], m["jparams"], m["jqs"], symmetric=sym)
        fn = jir.int8_model_fn(m["jq"], jrt[name], m["jparams"], m["jqs"], symmetric=sym)
        sample[name] = np.asarray(j_ddim_sample(fn, jnp.asarray(x), SEQ, betas))
    jqparams, _ = m["jq"].prepare_params(m["jparams"])
    fq8 = np.asarray(m["jq"].apply(jqparams, m["jqs"], jnp.asarray(x), jnp.asarray(t), 0, mode="int8"))
    return dict(m=m, x=x, t=t, jrt=jrt, sample=sample, jqparams=jqparams, fq8=fq8)


FOLD_CONVS = ("down.1.block.0.conv1", "down.1.block.0.nin_shortcut")  # 3x3 128 -> 256, 1x1 128 -> 256


def _held_fold(got, want, err_msg=""):
    """One conv's fold (gq, ws, wzp, zcorr, act_scale, act_zp) against JAX's,
    as tests/test_torch_fold.py holds the symmetric one on random logits: the
    two softmaxes' exp differ in the last bit, so the scales agree to 1e-6
    and a rare product crosses a rounding tie (measured: at most 3.4e-6 of gq
    off by 1); zcorr to 6.4e-6 of its largest value in the columns where no
    gq moved (measured 1.6e-6), zero points equal."""
    gq, ws, wzp, zc, scale, zp = (torch.as_tensor(a).numpy() for a in got)
    jgq, jws, jwzp, jzc, jscale, jzp = (np.asarray(a) for a in want)
    d = np.abs(gq.astype(np.int32) - jgq)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-5, (err_msg, d.max(), (d > 0).mean())
    np.testing.assert_array_equal(wzp, jwzp, err_msg=err_msg)
    np.testing.assert_array_equal(zp, jzp, err_msg=err_msg)
    for a, b in ((ws, jws), (scale, jscale)):
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=err_msg)
    moved = (d > 0).any(axis=1)  # [S, Np]: a column whose gq moved moves its zcorr
    np.testing.assert_allclose(zc[~moved], jzc[~moved], rtol=0, atol=6.4e-6 * np.abs(jzc).max(), err_msg=err_msg)


FOLD_CONVS = ("down.1.block.0.conv1", "up.1.block.0.conv1", "down.1.block.0.nin_shortcut")


@pytest.mark.parametrize("conv", FOLD_CONVS, ids=["3x3", "3x3_concat", "1x1"])
@pytest.mark.parametrize("mse_search", [True, False], ids=["mse", "unit_shrink"])
@pytest.mark.parametrize("sym", SYMMETRY, ids=list(SYMMETRY))
def test_fold_all_steps_matches_jax(chain, conv, mse_search, sym):
    """`_fold_all_steps` on one conv at both steps, symmetric or asymmetric
    (wzp nonzero), with the MSE shrink search or a unit shrink."""
    m = chain["m"]
    kernel = _jnode(m["jparams"], conv)["kernel"]
    jst, st, pol = m["jqs"][conv], m["qstates"][conv], m["jq"].policy[conv]
    want = jir._fold_all_steps(kernel, jst.group_ranges, jst.alpha_logits, pol.a_bit, pol.w_bit, SYMMETRY[sym],
                               mse_search)
    got = ir._fold_all_steps(_t(kernel), st.group_ranges, st.alpha_logits, pol.a_bit, pol.w_bit,
                             symmetric=SYMMETRY[sym], mse_search=mse_search)
    _held_fold(got, want, conv)
    assert (got[2].abs().sum() > 0) == (sym == "asymmetric")


def test_asymmetric_rank1_fold_raises(chain):
    st = chain["m"]["qstates"]["mid.block_1.conv1"]
    with pytest.raises(ValueError, match="rank1 shared folds require symmetric weights"):
        ir._fold_all_steps(torch.zeros(3, 3, 256, 256), st.group_ranges, st.alpha_logits, 8, 4, symmetric=False,
                           rank1=True)


def _conv_inputs(ksize, seed):
    """x in a conv's input range, the conv's kernel and bias, and its step-0
    mixed ranges, from `seed`."""
    rng = np.random.default_rng(seed)
    C, co = 128, 256
    x = (rng.standard_normal((2, 8, 8, C)) * 1.5 + 0.3).astype(np.float32)
    kernel = (rng.standard_normal((ksize, ksize, C, co)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.1).astype(np.float32)
    lo = -rng.uniform(0.5, 3.0, C).astype(np.float32)
    return x, kernel, bias, lo, (lo + rng.uniform(2.0, 6.0, C)).astype(np.float32)


@pytest.mark.parametrize("ksize", [3, 1])
def test_int8_products_match_jax_exactly(ksize):
    """K13 `conv3x3_int8_dot` and K5 `int8_matmul` against JAX's Pallas
    kernels (interpret mode): the same int32 sums."""
    rng = np.random.default_rng(ksize)
    if ksize == 3:
        xq = rng.integers(-128, 128, (2, 10, 10, 128)).astype(np.int8)
        wq = rng.integers(-8, 8, (9 * 128, 256)).astype(np.int8)
        want = jqc._conv3x3_int8_dot(jnp.asarray(xq), jnp.asarray(wq), 8, 8, 128, 256, interpret=True)
        got = qc.conv3x3_int8_dot(torch.from_numpy(xq), torch.from_numpy(wq))
    else:
        xq = rng.integers(-128, 128, (160, 256)).astype(np.int8)
        wq = rng.integers(-8, 8, (256, 128)).astype(np.int8)
        want = jqc.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), interpret=True)
        got = qc.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ksize", [3, 1])
@pytest.mark.parametrize("sym", SYMMETRY, ids=list(SYMMETRY))
def test_quantized_conv2d_int8_prefolded_matches_jax(ksize, sym):
    """The prefolded int8 conv on one fold, symmetric (no rowsum) and
    asymmetric (the exact integer rowsum: for 3x3 the box sum over the
    halo'd input), against JAX's: bit-equal (measured)."""
    x, kernel, bias, lo, hi = _conv_inputs(ksize, 10 + ksize)
    s = (255.0 / (hi - lo)).astype(np.float32)
    zp = (np.round(s * lo) + 128).astype(np.float32)
    jfold = jqc.fold_weights_int8(jnp.asarray(kernel), jnp.asarray(s), 4, symmetric=SYMMETRY[sym])
    gq, ws, wzp, g_hat = (np.asarray(a) for a in jfold)
    zc = np.asarray(jqc.zcorr_from_fold(jnp.asarray(g_hat), jnp.asarray(zp), ksize, 128))
    args = (x, gq, ws, wzp, zc, bias, s, zp)
    want = jqc.quantized_conv2d_int8_prefolded(*(jnp.asarray(a) for a in args), 8, ksize, 256,
                                                symmetric=SYMMETRY[sym])
    got = qc.quantized_conv2d_int8_prefolded(*(torch.tensor(a) for a in args), 8, ksize, 256,
                                             symmetric=SYMMETRY[sym])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rowsum_is_the_box_sum_of_channel_sums():
    """The asymmetric rowsum of a 3x3 conv, exact in int32: every output
    pixel's sum of the nine taps' codes."""
    xq = torch.from_numpy(np.random.default_rng(5).integers(-128, 128, (2, 6, 7, 256)).astype(np.int8))
    got = qc._rowsum(xq, 3).reshape(2, 4, 5)
    want = torch.zeros(2, 4, 5, dtype=torch.int64)
    for dy in range(3):
        for dx in range(3):
            want += xq[:, dy:dy + 4, dx:dx + 5].to(torch.int64).sum(dim=-1)
    assert got.dtype == torch.int32 and torch.equal(got.to(torch.int64), want)


# the per-call conv against JAX's, largest absolute difference, measured: 3.81e-6 (3x3), 7.15e-7 (1x1); zcorr is
# an f32 dot over the fold's K rows, summed in another order than XLA's
PER_CALL_ATOL = {3: 1.5e-5, 1: 2.9e-6}


@pytest.mark.parametrize("ksize", [3, 1])
def test_quantized_conv2d_int8_matches_jax(ksize):
    """The whole quantized conv folded per call (asymmetric weights), with
    JAX's K13 / K5 in interpret mode."""
    x, kernel, bias, lo, hi = _conv_inputs(ksize, 20 + ksize)
    args = (x, kernel, bias, lo, hi)
    want = jqc.quantized_conv2d_int8(*(jnp.asarray(a) for a in args), 8, 4, interpret=True)
    got = qc.quantized_conv2d_int8(*(torch.from_numpy(a) for a in args), 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PER_CALL_ATOL[ksize])
    with pytest.raises(ValueError):
        qc.quantized_conv2d_int8(*(torch.from_numpy(a) for a in args), 8, 4, stride=2)


@pytest.mark.parametrize("sym", SYMMETRY, ids=list(SYMMETRY))
def test_prepare_int8_runtime_matches_jax(chain, sym):
    """The port's whole-model fold of the same states against JAX's, layer
    by layer, held as `_fold_all_steps`; the K-major copy is gq's."""
    m = chain["m"]
    got = ir.prepare_int8_runtime(m["q"], m["params"], m["qstates"], symmetric=SYMMETRY[sym])
    want = chain["jrt"][sym]
    assert got.keys() == want.keys()
    for name, lay in got.items():
        ref = want[name]
        _held_fold((lay.gq, lay.ws, lay.wzp, lay.zcorr, lay.act_scale, lay.act_zp),
                   (ref.gq, ref.ws, ref.wzp, ref.zcorr, ref.act_scale, ref.act_zp), name)
        assert torch.equal(lay.gqt, lay.gq.transpose(-1, -2).contiguous()), name


def _records(chain, sym):
    """Every conv call of one port forward through the interception
    runtime on JAX's fold (step 0): (name, input, params node, stride,
    padding, output)."""
    m = chain["m"]
    rt = ir.from_jax_int8_runtime(chain["jrt"][sym], device="cpu")
    ca = ir.make_int8_conv_apply(rt, m["q"], m["qstates"], 0, symmetric=SYMMETRY[sym])
    calls = []

    def rec(name, x, p, *, stride=1, padding="SAME"):
        out = ca(name, x, p, stride=stride, padding=padding)
        calls.append((name, x, stride, padding, out))
        return out

    unet_apply(m["params"], m["cfg"], torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), conv_apply=rec)
    return calls


@pytest.mark.parametrize("sym", SYMMETRY, ids=list(SYMMETRY))
def test_int8_conv_apply_matches_jax_teacher_forced(chain, sym):
    """Each conv of one forward through `make_int8_conv_apply`, replayed by
    JAX's interceptor on the port's own input: the int8 convs (K13 / K5)
    bit-equal (measured), the fake-quant float convs (conv_in, the stride-2
    downsample) within 68 f32 ulp of the output's largest value (measured
    17: a float conv summed in another order)."""
    m = chain["m"]
    jca = jir.make_int8_conv_apply(chain["jrt"][sym], m["jq"], m["jqs"], 0, symmetric=SYMMETRY[sym])
    calls = _records(chain, sym)
    int8 = 0
    for name, x, stride, padding, out in calls:
        want = np.asarray(jca(name, jnp.asarray(x.numpy()), _jnode(m["jparams"], name), stride=stride,
                              padding=padding))
        if name in chain["jrt"][sym] and stride == 1:
            np.testing.assert_array_equal(out.numpy(), want, err_msg=name)
            int8 += 1
        else:
            np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=68 * np.spacing(np.abs(want).max()),
                                       err_msg=name)
    assert int8 == len(chain["jrt"][sym]) - 1  # every folded conv but the stride-2 downsample


# the 2-step DDIM sample through int8_model_fn on JAX's fold, mean relative error, measured: symmetric 7.94e-3,
# asymmetric 8.22e-4 (JAX's sampler is one jitted scan, whose fused float ops round a conv's dequant in another
# last bit than its op-by-op interceptor; an int8 code on a tie downstream carries that to the sample), bounded
# at twice that
SAMPLE_BOUND = {"symmetric": 1.6e-2, "asymmetric": 1.7e-3}


@pytest.mark.parametrize("sym", SYMMETRY, ids=list(SYMMETRY))
def test_int8_model_fn_sample_matches_jax(chain, sym):
    """A 2-step DDIM sample through the interception runtime's
    `int8_model_fn` (symmetric, and asymmetric with the rowsum term), on
    JAX's fold, against JAX's."""
    m = chain["m"]
    rt = ir.from_jax_int8_runtime(chain["jrt"][sym], device="cpu")
    fn = ir.int8_model_fn(m["q"], rt, m["params"], m["qstates"], symmetric=SYMMETRY[sym])
    sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")
    out = ddim_sample(fn, torch.from_numpy(chain["x"]), SEQ, sched.betas)
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["sample"][sym])
    assert rel < SAMPLE_BOUND[sym], rel


def test_qunet_int8_mode_matches_jax(chain):
    """One `QuantizedUNet.apply(mode="int8")` forward (each eligible conv
    folded per call, asymmetric, on the `prepare_params` weights; the rest
    fake-quant) against JAX's."""
    m = chain["m"]
    qparams = from_jax_params(jax.tree_util.tree_map(np.asarray, chain["jqparams"]), device="cpu")
    eps = m["q"].apply(qparams, m["qstates"], torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0,
                       mode="int8")
    assert torch.isfinite(eps).all()
    # measured 2.27e-2: each conv folds per call, and its zcorr (an f32 dot) sums in another order than
    # XLA's, which moves int8 codes on ties downstream; each conv alone: test_quantized_conv2d_int8_matches_jax
    rel = _rel(eps.numpy(), chain["fq8"])
    assert rel < 4.6e-2, rel
    # the eligible convs run the int8 path: it is not the fake-quant forward
    fq = m["q"].apply(qparams, m["qstates"], torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0)
    assert not torch.equal(eps, fq)


def test_mixed_ranges_feed_the_int8_mode(chain):
    """Mode "int8" quantizes at the step's mixed ranges: one conv through the
    interceptor equals `quantized_conv2d_int8` at `mixed_ranges`."""
    from attentiondm_tpu_torch.quant.qunet import make_quant_conv_apply

    m = chain["m"]
    name = "mid.block_1.conv1"
    p = _jnode(m["params"], name)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 4, 4, 256)).astype(np.float32))
    ca = make_quant_conv_apply(m["qstates"], m["q"].policy, 1, mode="int8")
    lo, hi = mixed_ranges(m["qstates"][name], 1)
    assert torch.equal(ca(name, x, p), qc.quantized_conv2d_int8(x, p["kernel"], p["bias"], lo, hi, 8, 4))


def test_asymmetric_surrogate_conv_matches_jax(chain):
    """The serving surrogate's conv at `symmetric=False` (stage 2 through the
    asymmetric fold), with a pinned shrink and round offsets, against JAX's
    (its interceptor taken from `serving_surrogate_apply`): within 1.2e-5
    (measured 2.98e-6: the float conv of the decoded weights summed in
    another order)."""
    from attentiondm_tpu.quant import adaround as jar
    from attentiondm_tpu.quant import calibrate as jcal
    from attentiondm_tpu_torch.quant.adaround import WeightExtras
    from attentiondm_tpu_torch.quant.calibrate import surrogate_conv_apply

    m, name = chain["m"], "mid.block_1.conv1"
    p = _jnode(m["jparams"], name)
    rng = np.random.default_rng(8)
    off = rng.integers(0, 2, p["kernel"].shape).astype(np.float32)
    shrink = rng.uniform(0.85, 1.0, p["kernel"].shape[3]).astype(np.float32)
    x = rng.standard_normal((2, 4, 4, 256)).astype(np.float32)
    captured, forward = [], jcal.unet_apply
    jcal.unet_apply = lambda params, cfg, xx, t, *, conv_apply: captured.append(conv_apply)
    try:
        jcal.serving_surrogate_apply(m["jq"], m["jparams"], m["jqs"],
                                     {name: jar.WeightExtras(round_offset=jnp.asarray(off), mu=None, shrink=jnp.asarray(shrink))},
                                     None, None, 1, symmetric=False)
    finally:
        jcal.unet_apply = forward
    want = np.asarray(captured[0](name, jnp.asarray(x), p))
    ex = {name: WeightExtras(round_offset=torch.from_numpy(off).to(torch.int16), mu=None,
                             shrink=torch.from_numpy(shrink))}
    got = surrogate_conv_apply(m["q"], m["qstates"], ex, 1, symmetric=False)(name, torch.from_numpy(x),
                                                                             _jnode(m["params"], name))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1.2e-5)
