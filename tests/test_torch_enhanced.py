"""PyTorch port vs the JAX package: the enhanced attention variant (FP,
fake-quant and served, with and without the stage-3 mixed-precision core)
and quant/attention_mp.py, on JAX's enhanced toy UNet at W4A8.

The JAX side runs once per module: the FP forward, the teacher trajectory,
stage-1 calibration, stage 3 (`make_logit_collector` and
`calibrate_mp_attention`), the fold, the fake-quant forward and one serving
step with and without the MP core (every attention site's input and output
recorded), and a 2-step serving sampler with the MP core.  `gamma` is set to
1 in the numpy tree both stacks load: at its init of 0 every enhanced block
is the identity."""
import functools

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
from attentiondm_tpu.models import unet as junet
from attentiondm_tpu.models.unet import iter_conv_layers as j_iter_conv_layers
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import attention_mp as jmp
from attentiondm_tpu.quant import calibrate_ranges as j_calibrate_ranges
from attentiondm_tpu.quant import int8_serving as js
from attentiondm_tpu.quant.qunet import make_quant_conv_apply as j_make_quant_conv_apply
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models import unet
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, iter_conv_layers, lookup, unet_apply
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.quant import attention_mp as mp
from attentiondm_tpu_torch.quant import int8_serving as srv
from attentiondm_tpu_torch.quant.int8_serving import ServingLayer, serving_ddim_sampler, serving_unet_apply
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet, make_quant_conv_apply
from attentiondm_tpu_torch.quant.state import from_jax_qstates


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0,
           attn_variant="enhanced")
SEQ = [0, 500]
BASE_BITS = 4  # W4A8's --bitwidth: effective bits 4 + 2 sigmoid(0.5) = 5.25, so the logits quantize at 5 bits
PROBES = (0, 250, 500, 750, 999)
SITES = ["down.0.attn.0", "mid.attn_1", "up.0.attn.0", "up.0.attn.1"]
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # JAX's bf16 residual: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _gamma(tree, value):
    """The numpy param tree with every enhanced block's gamma set to `value`."""
    if isinstance(tree, dict):
        return {k: np.full_like(v, value) if k == "gamma" else _gamma(v, value) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gamma(v, value) for v in tree]
    return tree


def _mp_np(states):
    return {n: {f: np.asarray(getattr(st, f)) for f in mp.FIELDS} for n, st in states.items()}


@pytest.fixture(scope="module")
def chain():
    jcfg = JConfig(**TOY)
    np_params = _gamma(jax.tree_util.tree_map(np.asarray, j_unet_init(jax.random.PRNGKey(0), jcfg)), 1.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(0)
    x_small = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.full((2,), 500.0, np.float32)
    eps_fp = np.asarray(j_unet_apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(t)))
    _, traj, _ = j_ddim_sample(lambda xt, tt, i: j_unet_apply(jparams, jcfg, xt, tt), jnp.asarray(x_small), SEQ,
                               betas, keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x_small)[None], traj[:-1]], axis=0)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs = j_calibrate_ranges(jq, jparams, jq.init_state(len(SEQ)), xs_in, SEQ, first=True)
    collect = jmp.make_logit_collector(jparams, jcfg, jnp.asarray(x_small))
    stats = {t_: {n: (float(a), float(b)) for n, (a, b) in collect(t_).items()} for t_ in PROBES}
    jmps = jmp.calibrate_mp_attention(lambda t_: stats[t_], {n: jmp.init_mp_attention_state(1000) for n in stats[0]},
                                      base_bits=BASE_BITS, timesteps=PROBES)
    ctx = {"mp_states": jmps, "base_bits": BASE_BITS, "timestep": jnp.asarray(500, jnp.int32)}
    jqp, _ = jq.prepare_params(jparams)
    ca = j_make_quant_conv_apply(jqs, jq.policy, 0, mode="infer")
    fq, fq_sites, block = {}, {}, junet._attn_apply_enhanced
    for mode in ("plain", "mp"):
        fq_sites[mode] = []

        def record_block(name, p, h, *args, _rec=fq_sites[mode]):
            out = block(name, p, h, *args)
            _rec.append((name, np.asarray(h), np.asarray(out)))
            return out

        junet._attn_apply_enhanced = record_block
        try:
            fq[mode] = np.asarray(j_unet_apply(jqp, jcfg, jnp.asarray(x), jnp.asarray(t), conv_apply=ca,
                                               attn_ctx=ctx if mode == "mp" else None))
        finally:
            junet._attn_apply_enhanced = block
    jrt = js.prepare_serving_runtime(jq, jparams, jqs)
    eps, sites, saved = {}, {}, js._attn_fused_enhanced
    for mode in ("plain", "mp"):
        sites[mode] = []

        def record(site, p, h_res, *args, _rec=sites[mode], **kw):
            out = saved(site, p, h_res, *args, **kw)
            _rec.append((site, np.asarray(h_res), np.asarray(out)))
            return out

        js._attn_fused_enhanced = record
        try:
            kw = dict(mp_states=jmps, mp_base_bits=BASE_BITS) if mode == "mp" else {}
            fn = js.serving_model_fn(jq, jrt, jparams, jqs, residual_dtype=jnp.bfloat16, attn_int8=False, **kw)
            eps[mode] = np.asarray(fn(jnp.asarray(x), jnp.asarray(t), 0))
        finally:
            js._attn_fused_enhanced = saved
    sample = np.asarray(js.serving_ddim_sampler(jq, jparams, jqs, SEQ, betas, residual_dtype=jnp.bfloat16,
                                                attn_int8=False, runtime=jrt, mp_states=jmps,
                                                mp_base_bits=BASE_BITS)(jnp.asarray(x)))
    # every compute flag at JAX's default: a float32 residual, attn_int8=True (which JAX ignores here)
    sample_default = np.asarray(js.serving_ddim_sampler(jq, jparams, jqs, SEQ, betas)(jnp.asarray(x)))
    runtime = {k: ServingLayer(*(torch.tensor(np.asarray(a)) for a in (v.gq, v.inv_ws, v.zcbias, v.act_scale,
                                                                        v.act_zp)))
               for k, v in jrt.items()}
    qs_np = {k: {f: np.asarray(getattr(v, f)) for f in FIELDS} for k, v in jqs.items()}
    return dict(np_params=np_params, params=from_jax_params(np_params, device="cpu"),
                qstates=from_jax_qstates(qs_np, device="cpu"), runtime=runtime, x_small=x_small, x=x, t=t,
                eps_fp=eps_fp, stats=stats, mp_np=_mp_np(jmps),
                mp_states=mp.from_jax_mp_states(_mp_np(jmps), device="cpu"), fq=fq, fq_sites=fq_sites, eps=eps,
                sites=sites, qparams=jax.tree_util.tree_map(np.asarray, jqp),
                sample=sample, sample_default=sample_default)


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")


def _serve(chain, mode, **kw):
    cfg, q, _ = _port()
    extra = dict(mp_states=chain["mp_states"], mp_base_bits=BASE_BITS) if mode == "mp" else {}
    return serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"], _t(chain["x"]),
                              _t(chain["t"]), 0, residual_dtype=torch.bfloat16, attn_int8=False, **extra, **kw)


# ---------------------------------------------------------------------------
# the FP model
# ---------------------------------------------------------------------------


def test_enhanced_fp_forward_matches_jax(chain):
    cfg, _, _ = _port()
    eps = unet_apply(chain["params"], cfg, _t(chain["x"]), _t(chain["t"]))
    # f32 products in another order: measured 1.4e-6 mean relative, 2.1e-6 at most
    assert np.abs(eps.numpy() - chain["eps_fp"]).max() < 8e-6


def test_enhanced_block_is_the_identity_at_gamma_0(chain):
    """JAX's init (gamma 0): each block returns its input to the bit, and
    the whole forward equals JAX's at gamma 0."""
    cfg, _, _ = _port()
    params = from_jax_params(_gamma(chain["np_params"], 0.0), device="cpu")
    h = torch.randn(2, 8, 8, 128, generator=torch.Generator().manual_seed(3)) * 2
    for site in SITES:
        assert torch.equal(unet._attn_apply_enhanced(site, lookup(params, site), h, unet._default_conv_apply, cfg), h)
    jcfg = JConfig(**TOY)
    want = j_unet_apply(jax.tree_util.tree_map(jnp.asarray, _gamma(chain["np_params"], 0.0)), jcfg,
                        jnp.asarray(chain["x"]), jnp.asarray(chain["t"]))
    # measured 2.6e-6 at most (f32 order)
    assert np.abs(unet_apply(params, cfg, _t(chain["x"]), _t(chain["t"])).numpy() - np.asarray(want)).max() < 1e-5


def _shapes(tree, path=""):
    """{dotted path: shape} of a nested dict / list tree of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _shapes(sub, f"{path}.{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _shapes(sub, f"{path}.{i}").items()}
    return {path: tuple(tree.shape)}


def test_enhanced_init_structure():
    """The port's init has JAX's tree: C // 8 query / key channels, gamma 0
    and the unused temperature 1, no GroupNorm."""
    cfg = UNetConfig(**TOY)
    params = unet.unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert _shapes(params) == _shapes(j_unet_init(jax.random.PRNGKey(0), JConfig(**TOY)))
    node = params["mid"]["attn_1"]
    assert node["key_conv"]["kernel"].shape == (1, 1, 128, 16) and "norm" not in node
    assert float(node["gamma"]) == 0.0 and float(node["temperature"]) == 1.0


@pytest.mark.parametrize("cfg_kw", [TOY, dict(attn_variant="enhanced")], ids=["toy", "cifar10"])
def test_enhanced_bit_policy_and_layers_match_jax(cfg_kw):
    """iter_conv_layers in lockstep with JAX's, and the W4A8 policy JAX's:
    key_conv at w4/a6/8 groups (k's rule), value_conv at 4 groups (v's)."""
    assert list(iter_conv_layers(UNetConfig(**cfg_kw))) == list(j_iter_conv_layers(JConfig(**cfg_kw)))
    got = QuantizedUNet.create(UNetConfig(**cfg_kw), 4, 8).policy
    want = JQuantizedUNet.create(JConfig(**cfg_kw), 4, 8).policy
    assert {k: (v.w_bit, v.a_bit, v.group_num) for k, v in got.items()} == \
        {k: (v.w_bit, v.a_bit, v.group_num) for k, v in want.items()}
    assert (got["mid.attn_1.key_conv"].w_bit, got["mid.attn_1.key_conv"].a_bit) == (4, 6)
    assert got["mid.attn_1.value_conv"].group_num == 4 and got["mid.attn_1.query_conv"].a_bit == 8


# ---------------------------------------------------------------------------
# quant/attention_mp.py
# ---------------------------------------------------------------------------


def _mp_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 64, 16)).astype(np.float32) * 2
    k = rng.standard_normal((2, 16, 64)).astype(np.float32) * 2
    v = rng.standard_normal((2, 64, 128)).astype(np.float32)
    imp = rng.standard_normal(1000).astype(np.float32) * 2
    return q, k, v, imp


@pytest.mark.parametrize("head_split", ["aligned", "ref"])
@pytest.mark.parametrize("base_bits,timestep", [(8, 123), (4, 123), (2, 123), (2, None)],
                         ids=["8bit", "4bit", "2bit", "2bit-no-timestep"])
def test_mp_attention_matches_jax(head_split, base_bits, timestep):
    """Both head splits at effective bits above 6 (no quantization), between
    4 and 6 (logits quantized) and at most 4 (logits and probabilities)."""
    q, k, v, imp = _mp_inputs(base_bits)
    jst = jmp.update_quant_params(jmp.init_mp_attention_state(1000), -6.0, 6.0, base_bits)
    jst = jmp.MPAttentionState(**{**{f: getattr(jst, f) for f in mp.FIELDS}, "timestep_importance": jnp.asarray(imp)})
    st = mp.from_jax_mp_states({"a": {f: np.asarray(getattr(jst, f)) for f in mp.FIELDS}}, device="cpu")["a"]
    ts = None if timestep is None else jnp.asarray(timestep, jnp.int32)
    want = np.asarray(jmp.mp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jst, num_heads=8,
                                       base_bits=base_bits, timestep=ts, head_split=head_split))
    got = mp.mp_attention(_t(q), _t(k), _t(v), st, num_heads=8, base_bits=base_bits,
                          timestep=None if timestep is None else torch.tensor(timestep), head_split=head_split)
    bits = float(mp.effective_bits(st, base_bits, timestep))
    assert bits == pytest.approx(float(jmp.effective_bits(jst, base_bits, ts)), abs=1e-6)
    # f32 products in another order; no logit sits on a rounding tie of the quantizer at these seeds (measured at
    # most 1.8e-7 mean relative, 1.2e-6 largest difference, over the eight cases)
    assert np.abs(got.numpy() - want).max() < 4.8e-6


def test_mp_head_splits_differ():
    """"ref" pairs head i's q channels with k channels {i, i + h, ...}: not the aligned split."""
    q, k, v, imp = _mp_inputs(0)
    st = mp.init_mp_attention_state(1000, "cpu")
    a, r = (mp.mp_attention(_t(q), _t(k), _t(v), st, num_heads=8, base_bits=8, head_split=hs) for hs in ("aligned", "ref"))
    assert _rel(a.numpy(), r.numpy()) > 1e-2
    with pytest.raises(ValueError, match="head_split"):
        mp.mp_attention(_t(q), _t(k), _t(v), st, num_heads=8, base_bits=8, head_split="other")


def test_update_quant_params_and_unsigned_quantizer_match_jax():
    st = mp.init_mp_attention_state(10, "cpu")
    jst = jmp.init_mp_attention_state(10)
    for lo, hi, bb in ((-3.25, 7.5, 4), (0.5, 0.5, 8), (-1e-3, 2.0, 6)):
        got = mp.update_quant_params(st, lo if bb == 8 else torch.tensor(lo), torch.tensor(hi), bb)
        want = jmp.update_quant_params(jst, jnp.float32(lo), jnp.float32(hi), bb)
        for f in mp.FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f"{lo} {f}")
    x = np.linspace(-2, 3, 401).astype(np.float32)
    for bits in (3.0, 5.0):
        np.testing.assert_array_equal(
            mp.quantize_unsigned(_t(x), torch.tensor(0.1), torch.tensor(17.0), torch.tensor(bits)).numpy(),
            np.asarray(jmp.quantize_unsigned(jnp.asarray(x), 0.1, 17.0, bits)))


def test_stage3_matches_jax(chain):
    """`make_logit_collector` + `calibrate_mp_attention` at the probe
    timesteps on the same images: every layer's logit range and quant params
    (f32 products in another order: measured 2.0e-6 and 8.0e-7 relative at most)."""
    cfg, _, _ = _port()
    collect = mp.make_logit_collector(chain["params"], cfg, _t(chain["x_small"]))
    for t_ in (0, 999):
        got = collect(t_)
        assert sorted(got) == SITES
        for name, (lo, hi) in got.items():
            np.testing.assert_allclose([float(lo), float(hi)], chain["stats"][t_][name], rtol=8e-6, err_msg=name)
    states = mp.calibrate_mp_attention(collect, {n: mp.init_mp_attention_state(1000, "cpu") for n in SITES},
                                       base_bits=BASE_BITS, timesteps=PROBES)
    for name in SITES:
        for f in mp.FIELDS:
            np.testing.assert_allclose(getattr(states[name], f).numpy(), chain["mp_np"][name][f], rtol=3e-6,
                                       err_msg=f"{name}.{f}")


# ---------------------------------------------------------------------------
# the fake-quant model and the serving path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["plain", "mp"])
def test_fake_quant_enhanced_matches_jax(chain, mode):
    """The W4A8 fake-quant enhanced model, with and without the MP core at
    the diffusion timestep, as the JAX runner builds it: `prepare_params`
    equal to JAX's, every enhanced block replayed on JAX's own input equal to
    JAX's output to the bit, and the whole forward held to the
    fake-quant model's gross-fault bound (test_torch_qunet_fq.py): the
    float convs' last bits flip an activation code on a rounding tie and the
    later quantizers carry it (measured 1.6e-2 plain, 1.5e-2 MP)."""
    cfg, q, _ = _port()
    qparams, _ = q.prepare_params(chain["params"])
    for name in q.policy:
        np.testing.assert_array_equal(lookup(qparams, name)["kernel"].numpy(), lookup(chain["qparams"], name)["kernel"])
    ctx = {"mp_states": chain["mp_states"], "base_bits": BASE_BITS, "timestep": torch.tensor(500)}
    ctx = ctx if mode == "mp" else None
    ca = make_quant_conv_apply(chain["qstates"], q.policy, 0, mode="infer")
    assert [s for s, _h, _o in chain["fq_sites"][mode]] == SITES
    for name, h, want in chain["fq_sites"][mode]:
        got = unet._attn_apply_enhanced(name, lookup(qparams, name), _t(h), ca, cfg, ctx)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    eps = unet_apply(qparams, cfg, _t(chain["x"]), _t(chain["t"]), conv_apply=ca, attn_ctx=ctx)
    assert torch.isfinite(eps).all()
    rel = _rel(eps.numpy(), chain["fq"][mode])
    assert rel < 5e-2, rel
    if mode == "mp":
        assert _rel(chain["fq"]["mp"], chain["fq"]["plain"]) > 1e-3  # the MP core is engaged


@pytest.mark.parametrize("mode", ["plain", "mp"])
def test_serving_step_enhanced_matches_jax(chain, mode):
    """One serving step on JAX's qstates and fold, chained, with and without
    the MP core; the MP step differs from the plain one."""
    eps = _serve(chain, mode)
    assert torch.isfinite(eps).all()
    # measured bit-equal in both modes
    np.testing.assert_array_equal(eps.numpy(), chain["eps"][mode])
    if mode == "mp":
        assert _rel(eps.numpy(), chain["eps"]["plain"]) > 1e-3


@pytest.mark.parametrize("mode", ["plain", "mp"])
def test_serving_sites_enhanced_match_jax_teacher_forced(chain, mode):
    """Every enhanced site of JAX's serving step replayed by the port's
    `_attn_fused_enhanced` on JAX's own input: the bf16 residual equal to
    JAX's to the bit; its four projections are K1 launches in 1x1 int32 mode
    and no attention kernel runs."""
    cfg, q, _ = _port()
    rt_i = srv.gather_step(chain["runtime"], 0)
    mp_ctx = None
    if mode == "mp":
        mp_ctx = dict(mp_states=chain["mp_states"], base_bits=BASE_BITS, timestep=torch.tensor(500))
    calls = []
    saved = srv._k1
    try:
        srv._k1 = lambda *a, **k: (calls.append((k.get("ksize"), k.get("out_dtype", torch.int32))), saved(*a, **k))[1]
        assert [s for s, _h, _o in chain["sites"][mode]] == SITES
        for site, h_res, want in chain["sites"][mode]:
            got = srv._attn_fused_enhanced(site, lookup(chain["params"], site), _t(h_res), rt_i, q, chain["qstates"],
                                           0, torch.bfloat16, mp_ctx=mp_ctx)
            assert torch.equal(got, _t(want)), site
    finally:
        srv._k1 = saved
    assert calls == [(1, torch.int32)] * 4 * len(SITES)
    plan = checks.expected_launches(cfg, 1, 2, attn_int8=False)
    assert plan["K3"] == plan["K8"] == plan["K11"] == plan["K3.int8_core"] == 0
    # four projections a site, and the up path's two nin_shortcuts
    assert plan["K5"] == 4 * len(SITES) + 2 and checks.attention_plan(cfg, attn_int8=False)["refused"] == []
    assert [s for s, _L, _C in checks.attention_sites(cfg)] == SITES


def test_enhanced_sampler_matches_jax_and_chunks_bit_equal(chain):
    """The 2-step serving sampler with the MP core: within the toy sampler's
    bound of JAX's (the port folds JAX's qstates itself), and chunked a step
    at a time bit-equal to the unchunked one; without the MP core it differs."""
    cfg, q, sched = _port()
    kw = dict(residual_dtype=torch.bfloat16, attn_int8=False, mp_states=chain["mp_states"], mp_base_bits=BASE_BITS)
    x = _t(chain["x"])
    out = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, **kw)(x)
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["sample"])
    # measured 4.3e-3 (test_torch_serving's ddim sampler: 7.0e-3, zcbias's last bits)
    assert rel < 1e-2, rel
    chunked = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, step_chunk=1,
                                   micro_batch=1, **kw)(x)
    assert torch.equal(chunked, out)
    plain = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, residual_dtype=torch.bfloat16,
                                 attn_int8=False)(x)
    assert _rel(plain.numpy(), out.numpy()) > 1e-4


def test_enhanced_default_sampler_matches_jax_default(chain):
    """The sampler called with its defaults (`attn_int8=None`: the variant's
    own, no int8 core on the enhanced block; a float32 residual) returns
    JAX's default-argument sample within the enhanced sampler's bound, and
    the `attn_int8=False` call's bits."""
    cfg, q, sched = _port()
    x = _t(chain["x"])
    out = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas)(x)
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["sample_default"])
    assert rel < 1e-2, rel
    assert torch.equal(out, serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas,
                                                 attn_int8=False)(x))
    with pytest.raises(ValueError, match="attn_int8=False or None"):
        serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, attn_int8=True)


@pytest.mark.parametrize("flags", [dict(), dict(attn_int8=True), dict(attn_int8=False, attn_ranges={})],
                         ids=["default", "attn_int8", "attn_ranges"])
def test_enhanced_refuses_the_int8_attention_flags(chain, flags):
    """The enhanced core is float32: an explicit `attn_int8=True` and
    `attn_ranges` raise ValueError in the step and the sampler, where JAX
    ignores them; the default (`attn_int8=None`, the variant's own) takes
    the float32 core, the bits of `attn_int8=False`; `mp_states` on the
    ddim variant raise too."""
    cfg, q, sched = _port()
    step = functools.partial(serving_unet_apply, chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                             _t(chain["x"]), _t(chain["t"]), 0, residual_dtype=torch.bfloat16)
    if not flags:
        assert torch.equal(step(), step(attn_int8=False))
    else:
        with pytest.raises(ValueError, match="attn_int8=False"):
            step(**flags)
        with pytest.raises(ValueError, match="attn_int8=False"):
            serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, residual_dtype=torch.bfloat16,
                                 **flags)
    ddim = UNetConfig(**{**TOY, "attn_variant": "ddim"})
    with pytest.raises(ValueError, match="enhanced attention variant only"):
        serving_ddim_sampler(QuantizedUNet.create(ddim, 4, 8), {}, {}, SEQ, sched.betas,
                             residual_dtype=torch.bfloat16, mp_states=chain["mp_states"])
