"""PyTorch port vs the JAX package: the serving forward and the serving DDIM
sampler at JAX's defaults, the float32 residual stream, and the remaining
flag values on the toy of tests/test_torch_serving.py: each lever at float32
(K3 and K12 take the toy's maps, K4 reads and K7 writes the f32 stream),
`dot_bf16=False` (K2 / K7 on K1's int32 accumulator) and every `conv_pallas`
value.  The narrow toy whose convs the fold does not cover and
`resamp_with_conv=False` are tests/test_torch_unfused.py.

The JAX side runs once per module, its Pallas kernels in interpret mode.  The
activation ranges are made from a seed with numpy (random group ranges and
mixture logits per step), not calibrated: the calibration is held to JAX in
tests/test_torch_serving.py, and this file holds what the forward does with
any ranges.  The port serves JAX's fold (converted), so a difference is the
forward's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import int8_serving as js
from attentiondm_tpu.quant.int8_serving import prepare_serving_runtime as j_prepare
from attentiondm_tpu.quant.int8_serving import serving_ddim_sampler as j_sampler
from attentiondm_tpu.quant.int8_serving import serving_model_fn as j_model_fn
from attentiondm_tpu.quant.state import ActQuantState as JActQuantState
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.quant import int8_serving as srv
from attentiondm_tpu_torch.quant.int8_serving import ServingLayer, serving_ddim_sampler, serving_unet_apply
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
SEQ = [0, 500]
B = 2
ALL = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
F32 = dict(residual_dtype=torch.float32, attn_int8=False)
# one serving step each, on TOY; "defaults" passes no flag at all (attn_int8=True, residual float32), the rest the
# f32 core at a float32 residual stream passed explicitly
STEPS = {
    "defaults": {},
    "off": F32,
    "entry_pallas": {**F32, "entry_pallas": True},
    "boundary_fusion": {**F32, "boundary_fusion": True},
    "resblock_pallas": {**F32, "resblock_pallas": "all"},
    "all_three": {**F32, **ALL},
    "dot_bf16_false": {**F32, "dot_bf16": False},
    "dot_bf16_false_levers": {**F32, "dot_bf16": False, **ALL},
}
SAMPLERS = ("off", "all_three", "dot_bf16_false")
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _jflags(kw):
    """The port's flags as JAX's: dtypes by name, and `entry_pallas`: the
    port runs every GroupNorm entry K4 takes on K4 at any flags, and on this
    toy every entry fits JAX's budget, so JAX's K4 at every entry."""
    out = {**kw, "entry_pallas": True}
    if "residual_dtype" in out:
        out["residual_dtype"] = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out["residual_dtype"]]
    return out


def _seeded_states(jq, seed):
    """Every conv's activation quant state with random group ranges (min in
    [-3, -0.5], max in [1, 4]) and mixture logits, numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, st in jq.init_state(len(SEQ)).items():
        S, G, _ = st.group_ranges.shape
        C = st.alpha_logits.shape[-1]
        gr = np.stack([-rng.uniform(0.5, 3.0, (S, G)), rng.uniform(1.0, 4.0, (S, G))], -1).astype(np.float32)
        out[name] = dict(init_range=np.asarray(st.init_range), act_min=np.asarray(st.act_min),
                         act_max=np.asarray(st.act_max), group_ranges=gr,
                         alpha_logits=rng.standard_normal((S, G, C)).astype(np.float32))
    return out


def _model(toy, seed):
    """One toy on both sides: JAX params, seeded states and JAX's fold, and
    the port's copies of each."""
    jcfg = JConfig(**toy)
    jparams = j_unet_init(jax.random.PRNGKey(seed), jcfg)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    qs_np = _seeded_states(jq, seed)
    jqs = {k: JActQuantState(**{f: jnp.asarray(v[f]) for f in FIELDS}) for k, v in qs_np.items()}
    jrt = j_prepare(jq, jparams, jqs)
    runtime = {k: ServingLayer(*(torch.tensor(np.asarray(a)) for a in (v.gq, v.inv_ws, v.zcbias, v.act_scale,
                                                                       v.act_zp)))
               for k, v in jrt.items()}
    cfg = UNetConfig(**toy)
    return dict(jcfg=jcfg, jparams=jparams, jq=jq, jqs=jqs, jrt=jrt, cfg=cfg, q=QuantizedUNet.create(cfg, 4, 8),
                params=from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                qstates=from_jax_qstates(qs_np, device="cpu"), runtime=runtime)


def _inputs():
    rng = np.random.default_rng(0)
    return rng.standard_normal((B, 8, 8, 3)).astype(np.float32), np.full((B,), 500.0, np.float32)


def _jax_step(m, x, t, **kw):
    return np.asarray(j_model_fn(m["jq"], m["jrt"], m["jparams"], m["jqs"], **_jflags(kw))(
        jnp.asarray(x), jnp.asarray(t), 0))


def _jax_sample(m, x, **kw):
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    return np.asarray(j_sampler(m["jq"], m["jparams"], m["jqs"], SEQ, betas, runtime=m["jrt"], **_jflags(kw))(
        jnp.asarray(x)))


@pytest.fixture(scope="module")
def chain():
    """The toy, and JAX's serving steps and 2-step samplers on it."""
    x, t = _inputs()
    m = _model(TOY, 0)
    eps = {name: _jax_step(m, x, t, **kw) for name, kw in STEPS.items()}
    sample = {name: _jax_sample(m, x, **STEPS[name]) for name in SAMPLERS}
    return dict(m=m, x=x, t=t, eps=eps, sample=sample)


def _step(m, x, t, **kw):
    return serving_unet_apply(m["params"], m["cfg"], m["q"], m["runtime"], m["qstates"], torch.from_numpy(x),
                              torch.from_numpy(t), 0, **kw)


def _sampler(m, **kw):
    sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")
    return serving_ddim_sampler(m["q"], m["params"], m["qstates"], SEQ, sched.betas, runtime=m["runtime"], **kw)


# One serving step against JAX's.  Levers off, entry_pallas and boundary_fusion at the float32 stream are
# bit-equal to JAX's (measured).  Where a GroupNorm sums float32 values that are not bf16 (K12's, and K2 / K7
# on the int32 accumulator with dot_bf16=False), or K3's int8 core's dynamic scales, the port's windowed sums
# and JAX's one-hot sums differ in the last bits; the block replays below are within 1 ulp but for the one int8
# code a replay flips (test_f32_stream_blocks_match_jax_teacher_forced), and the chained quantizers carry such
# codes to the output: mean relative error 2.27e-2 (defaults), 2.93e-2 (resblock_pallas), 2.96e-2 (all_three),
# 2.98e-2 (dot_bf16=False with or without the levers), bounded at about twice that.
BIT_EQUAL = ("off", "entry_pallas", "boundary_fusion")
STEP_BOUND = {"defaults": 5e-2, "resblock_pallas": 6e-2, "all_three": 6e-2, "dot_bf16_false": 6e-2,
              "dot_bf16_false_levers": 6e-2}
# the 2-step sampler, mean relative error: measured 1.16e-7 (off), 7.70e-3 (all_three), 7.71e-3 (dot_bf16_false)
SAMPLER_BOUND = {"off": 4e-7, "all_three": 1.5e-2, "dot_bf16_false": 1.5e-2}


@pytest.mark.parametrize("name", STEPS)
def test_f32_stream_step_matches_jax(chain, name):
    """One serving_unet_apply at the float32 residual stream (passed, or with
    no flag at all: JAX's defaults), levers off, each on, all three, and
    `dot_bf16=False` with and without them, against JAX's serving forward
    under the same flags on JAX's fold."""
    eps = _step(chain["m"], chain["x"], chain["t"], **STEPS[name])
    assert eps.dtype == torch.float32 and eps.shape == chain["eps"][name].shape and torch.isfinite(eps).all()
    if name in BIT_EQUAL:
        np.testing.assert_array_equal(eps.numpy(), chain["eps"][name])
    else:
        rel = _rel(eps.numpy(), chain["eps"][name])
        assert rel < STEP_BOUND[name], rel


@pytest.mark.parametrize("name", SAMPLERS)
def test_f32_stream_sampler_matches_jax(chain, name):
    """The 2-step serving sampler at the float32 stream, levers off, all
    three, `dot_bf16=False`, on JAX's fold."""
    out = _sampler(chain["m"], **STEPS[name])(torch.from_numpy(chain["x"]))
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["sample"][name])
    assert rel < SAMPLER_BOUND[name], rel


def _jnode(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return tree


# Each block replayed by JAX on the port's inputs: 1 f32 ulp apart (at most 2.4e-7 here) but for one block a case
# whose one flipped int8 code moves 4.4% of its outputs, mean relative 3.5e-5 (dot_bf16=False with the levers,
# up.0.block.1); bounded at 1.4e-4 a block, and at most one block a case off 1e-6.
BLOCK_REL, BLOCK_ULP = 1.4e-4, 1e-6


@pytest.mark.parametrize("name", ["all_three", "dot_bf16_false_levers"])
def test_f32_stream_blocks_match_jax_teacher_forced(chain, name):
    """Every resblock and attention block of one port step at the float32
    stream, replayed by JAX's `_resblock_fused` / `_attn_fused` on the port's
    own inputs (residual, temb, carried sums) with the same flags: K12, K4,
    K7 and K3 at f32 (all three levers), and K2 / K7 on the int32
    accumulator (`dot_bf16=False`).  Unlike the whole step, no code flipped
    upstream moves a replay."""
    m = chain["m"]
    calls = []
    rb, at = srv._resblock_fused, srv._attn_fused

    def rb_spy(bname, p, h_res, temb_act, rt_i, qunet, res_dtype, **kw):
        out = rb(bname, p, h_res, temb_act, rt_i, qunet, res_dtype, **kw)
        calls.append((bname, h_res, temb_act, kw, out))
        return out

    def at_spy(aname, p, h_res, rt_i, qunet, res_dtype, **kw):
        out = at(aname, p, h_res, rt_i, qunet, res_dtype, **kw)
        calls.append((aname, h_res, None, kw, (out, None)))
        return out

    srv._resblock_fused, srv._attn_fused = rb_spy, at_spy
    try:
        _step(m, chain["x"], chain["t"], **STEPS[name])
    finally:
        srv._resblock_fused, srv._attn_fused = rb, at
    jrt_i = {k: js._unpack_layer(v) for k, v in js.gather_step(m["jrt"], 0).items()}
    off = []
    for bname, h_res, temb_act, kw, (out, sums) in calls:
        p, h = _jnode(m["jparams"], bname), jnp.asarray(h_res.numpy())
        if temb_act is None:
            jout, jsums = js._attn_fused(bname, p, h, jrt_i, m["jq"], m["jqs"], 0, jnp.float32, False), None
        else:
            es = kw.get("entry_sums")
            jout, jsums = js._resblock_fused(
                bname, p, h, jnp.asarray(temb_act.numpy()), jrt_i, m["jq"], m["jqs"], 0, jnp.float32,
                entry_sums=None if es is None else jnp.asarray(es.numpy()), want_exit_stats=kw.get("want_exit_stats", False),
                dot_bf16=kw["dot_bf16"], entry_pallas=True, resblock_pallas=kw["resblock_pallas"])
        assert out.dtype == torch.float32, bname
        got, want = out.numpy().astype(np.float64), np.asarray(jout).astype(np.float64)
        assert _rel(got, want) < BLOCK_REL, bname
        off += [bname] if np.abs(got - want).max() > BLOCK_ULP else []
        assert (sums is None) == (jsums is None), bname
        if sums is not None:
            np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5, err_msg=bname)
    assert len(calls) == 12 and len(off) <= 1, off


def test_residual_dtype_defaults_to_float32(chain):
    """`residual_dtype` defaults to float32 in the step and the sampler, as
    in JAX: no flag gives the bits of residual_dtype=torch.float32, and the
    bf16 stream gives others.  The residual between blocks is float32."""
    m, x, t = chain["m"], chain["x"], chain["t"]
    seen = []
    orig = srv._resblock_fused

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[0].dtype)
        return out

    srv._resblock_fused = spy
    try:
        default = _step(m, x, t, attn_int8=False)
    finally:
        srv._resblock_fused = orig
    assert seen and set(seen) == {torch.float32}
    assert torch.equal(default, _step(m, x, t, **F32))
    assert not torch.equal(default, _step(m, x, t, attn_int8=False, residual_dtype=torch.bfloat16))
    xs = torch.from_numpy(x)
    assert torch.equal(_sampler(m, attn_int8=False)(xs), _sampler(m, **F32)(xs))


CONV_PALLAS = {"true": True, "all": "all", "triples": [(8, 128, 128), (4, 256, 256)], "set": {(8, 128, 128)},
               "empty": ()}


@pytest.mark.parametrize("value", CONV_PALLAS, ids=list(CONV_PALLAS))
def test_conv_pallas_values_equal_off(chain, value):
    """Every value JAX takes for `conv_pallas` is taken, and, every int8 conv
    being K1 already, gives the bits of conv_pallas=False, in both conv
    layouts."""
    m, x, t = chain["m"], chain["x"], chain["t"]
    for kw in ({}, {"dot_bf16": False}):
        off = _step(m, x, t, **F32, **kw)
        assert torch.equal(_step(m, x, t, **F32, **kw, conv_pallas=CONV_PALLAS[value]), off)


def k1_modes(step):
    """(ksize, stride, out dtype) of every K1 call `step()` makes through the
    serving module, sorted, and the K2 / K6 calls' input dtypes."""
    k1, epi = [], []
    saved = srv._k1, srv.epilogue_gn_swish_quant

    def k1_spy(xp, gq, *a, ksize=3, stride=1, out_dtype=torch.int32, **k):
        k1.append((ksize, stride, out_dtype))
        return saved[0](xp, gq, *a, ksize=ksize, stride=stride, out_dtype=out_dtype, **k)

    def epi_spy(dot, *a, **k):
        epi.append(dot.dtype)
        return saved[1](dot, *a, **k)

    srv._k1, srv.epilogue_gn_swish_quant = k1_spy, epi_spy
    try:
        step()
    finally:
        srv._k1, srv.epilogue_gn_swish_quant = saved
    return sorted(k1, key=str), epi


@pytest.mark.parametrize("dot_bf16", [True, False])
def test_conv_plan_matches_the_forward(chain, dot_bf16):
    """`ops.checks.conv_plan(dot_bf16=)` names exactly the K1 launches (by
    mode) and epilogue kernels of one forward: with `dot_bf16=False` the
    resblock convs in int32 mode and K2 on the int32 accumulator."""
    m = chain["m"]
    k1, epi = k1_modes(lambda: _step(m, chain["x"], chain["t"], **F32, dot_bf16=dot_bf16))
    plan, k2, k6, _k3, _composed = checks.conv_plan(m["cfg"], dot_bf16=dot_bf16)
    assert k1 == sorted(((k, s, mode) for _n, _H, _Cp, _Np, k, s, mode in plan), key=str)
    assert epi == [torch.bfloat16 if dot_bf16 else torch.int32] * (len(k2) + len(k6))
    counts = checks.expected_launches(m["cfg"], 1, B, **F32, dot_bf16=dot_bf16)
    # the upsample and conv_out, and with dot_bf16=False both convs of the toy's eight resblocks
    assert counts["K13"] == sum(1 for c in k1 if c == (3, 1, torch.int32)) == 2 + (0 if dot_bf16 else 16)


def test_jax_default_flags_are_the_ports():
    """The serving entry points' defaults are JAX's: residual float32,
    attn_int8 (None, the variant's own, which is JAX's True on the ddim
    variant), dot_bf16, every lever off."""
    import inspect

    from attentiondm_tpu.quant import int8_serving as js

    for port, ref in ((serving_unet_apply, js.serving_unet_apply), (serving_ddim_sampler, js.serving_ddim_sampler)):
        pd, jd = inspect.signature(port).parameters, inspect.signature(ref).parameters
        assert pd["residual_dtype"].default == torch.float32 and jd["residual_dtype"].default == jnp.float32
        assert pd["attn_int8"].default is None
        assert srv._require_attention_flags(UNetConfig(), None, None, None) is jd["attn_int8"].default is True
        for flag in ("dot_bf16", "entry_pallas", "boundary_fusion", "conv_pallas", "resblock_pallas"):
            assert pd[flag].default == jd[flag].default, flag
