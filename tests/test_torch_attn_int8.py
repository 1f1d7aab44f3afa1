"""PyTorch port vs the JAX package: the attention cores K8, K9, K10, K11 and
K3's int8 core (the plain versions the wrappers run on CPU tensors, against
the JAX functions with their Pallas kernels in interpret mode), the attention
ranges of stage-1 calibration, and the serving slice under the three
attention settings on a toy that attends at 32x32 (L = 1024 at C = 128: the
composed branch, K9 with `attn_ranges`, K8 without, K11 with
`attn_int8=False`) and 16x16 (L = 256 at C = 256: K3, its int8 core under
`attn_int8`).

Tolerances.  int8 outputs (K8, K9, K10): codes at most 1 LSB apart on at most
0.2% (K8, K9) or 1% (K10) of them, the bounds the JAX package's own tests hold
its kernels to against its references.  K11: atol = rtol = 2e-5, as JAX's
test of it.  K3 and a whole attention site (bf16 residual out): mean relative
error < 1e-3 and 99% of the elements within 1 bf16 ulp
(`ops.checks.compare`).  The measured figures stand at each test."""
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion import ddim_sample as j_ddim_sample
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.models.unet import conv2d as j_conv2d
from attentiondm_tpu.ops import attention as j_attention
from attentiondm_tpu.ops import int8_attention as j_i8
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import calibrate_ranges as j_calibrate_ranges
from attentiondm_tpu.quant import int8_serving as js
from attentiondm_tpu.quant.calibrate import _calibrate_one_conv as j_calibrate_one_conv
from attentiondm_tpu_torch.models.unet import UNetConfig, conv2d, from_jax_params
from attentiondm_tpu_torch.ops import attention, checks
from attentiondm_tpu_torch.ops import int8_attention as ia
from attentiondm_tpu_torch.quant import int8_serving as srv
from attentiondm_tpu_torch.quant.calibrate import _calibrate_one_conv, _is_attn_proj, calibrate_ranges
from attentiondm_tpu_torch.quant.int8_serving import ServingLayer, serving_unet_apply
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
from attentiondm_tpu_torch.quant.state import from_jax_attn_ranges, from_jax_qstates


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # exact
    return torch.from_numpy(np.array(a))


def _code_diff(got, want):
    """(largest difference, share of differing codes) of two int8 tensors."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float((d > 0).mean())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,L,D,blocks", [(2, 1024, 128, {}), (1, 512, 128, dict(block_q=256, block_k=256))],
                         ids=["L1024", "L512_blocks256"])
def test_k11_matches_jax(B, L, D, blocks):
    rng = np.random.default_rng(L)
    q, k, v = (rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_attention.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True, **blocks))
    before = attention.flash_attention.launches
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **blocks).numpy()
    assert attention.flash_attention.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)  # measured max abs 2.1e-7


def test_k11_extreme_logits_stay_finite():
    """q = k = 30: logits of 900 * D overflow exp without the running maximum;
    every key weighs the same, so the output is v's mean."""
    B, L, D = 1, 512, 128
    q = torch.full((B, L, D), 30.0)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((B, L, D)).astype(np.float32))
    out = attention.flash_attention(q, q, v, scale=1.0)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0, 0].numpy(), v.mean(dim=1)[0].numpy(), atol=1e-4)
    want = np.asarray(j_attention.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()),
                                                  jnp.asarray(v.numpy()), scale=1.0, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("L,D,flash", [(1024, 128, True), (256, 128, False), (1024, 64, False)],
                         ids=["long", "short", "unaligned"])
def test_spatial_attention_dispatch(L, D, flash):
    """L >= 1024 on the (256, 128) grids takes K11's route, the rest the
    dense softmax; both agree with JAX's dispatcher."""
    rng = np.random.default_rng(D)
    q, k, v = (rng.standard_normal((1, L, D)).astype(np.float32) for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention.spatial_attention(tq, tk, tv)
    assert torch.equal(got, attention.flash_attention_ref(tq, tk, tv)) == flash
    want = np.asarray(j_attention.spatial_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_attention_refuses_blocks_that_do_not_divide():
    q = torch.zeros(1, 2304, 128)  # 2304 % 512 != 0: JAX's kernel asserts here
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# K8, K9, K10
# ---------------------------------------------------------------------------


def _dyn_inputs(B, L, C, seed):
    rng = np.random.default_rng(seed)
    dots = [rng.integers(-(2 ** 15), 2 ** 15, (B, L, C), dtype=np.int32) for _ in range(3)]
    epis = [((np.exp(0.1 * rng.standard_normal(C)) * 1e-4).astype(np.float32),
             (0.1 * rng.standard_normal(C)).astype(np.float32)) for _ in range(3)]
    return dots, epis, np.full(C, 20.0, np.float32), np.zeros(C, np.float32)


@pytest.mark.parametrize("B,L,C", [(2, 256, 128), (2, 64, 128)], ids=["aligned", "gate_L64"])
def test_k8_matches_jax(B, L, C):
    """K8's plain version against `fused_int8_attention`: the Pallas kernel at
    the aligned shape, and JAX's own plain reference at L = 64, where its
    gate sends the call.  Measured: one code in 65536 (3.1e-5) one step apart
    at the aligned shape, none at L = 64."""
    dots, epis, s, z = _dyn_inputs(B, L, C, 7)
    jepis = [tuple(map(jnp.asarray, e)) for e in epis]
    want = j_i8.fused_int8_attention(*map(jnp.asarray, dots), *jepis, jnp.asarray(s), jnp.asarray(z), 8,
                                     scale=C ** -0.5, interpret=True)
    before = ia.fused_int8_attention.launches
    got = ia.fused_int8_attention(*map(_t, dots), *[tuple(map(_t, e)) for e in epis], _t(s), _t(z), 8,
                                  scale=C ** -0.5)
    assert ia.fused_int8_attention.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.int8 and tuple(got.shape) == (B, L, C)
    worst, frac = _code_diff(got.numpy(), want)
    assert worst <= 1 and frac <= 2e-3, (worst, frac)


def _static_inputs(B, L, C, seed):
    rng = np.random.default_rng(seed)
    q8, k8, v8 = (rng.integers(-127, 128, (B, L, C)).astype(np.int8) for _ in range(3))
    scal = [np.float32(x) for x in (0.013, 0.011, 0.02)]
    out_scale = (np.abs(rng.standard_normal(C)) + 1.0).astype(np.float32)
    out_zp = np.round(rng.standard_normal(C) * 3).astype(np.float32)
    return (q8, k8, v8), scal, out_scale, out_zp


def test_k9_matches_jax():
    """K9's plain version against `fused_int8_attention_static` (Pallas, (2,
    256, 128)).  Measured: 0 codes differ."""
    B, L, C = 2, 256, 128
    qkv, scal, s, z = _static_inputs(B, L, C, 9)
    want = j_i8.fused_int8_attention_static(*map(jnp.asarray, qkv), *map(jnp.asarray, scal), jnp.asarray(s),
                                            jnp.asarray(z), 8, scale=C ** -0.5, interpret=True)
    assert not ia.static_core_takes_flash(L, C)
    got = ia.fused_int8_attention_static(*map(_t, qkv), *(torch.tensor(x) for x in scal), _t(s), _t(z), 8,
                                         scale=C ** -0.5)
    worst, frac = _code_diff(got.numpy(), want)
    assert worst <= 1 and frac <= 2e-3, (worst, frac)


def test_k10_matches_jax_and_is_routed():
    """K10's plain version against `int8_flash_attention_static` at (1, 2304,
    128), where the key blocks snap from 512 to 256, and the dispatcher's
    routing of that shape.  Measured: 0 codes differ."""
    B, L, C = 1, 2304, 128
    qkv, scal, s, z = _static_inputs(B, L, C, 11)
    want = j_i8.int8_flash_attention_static(*map(jnp.asarray, qkv), jnp.stack(list(map(jnp.asarray, scal))).reshape(1, 3),
                                            jnp.asarray(s), jnp.asarray(z), 8, scale=C ** -0.5, interpret=True)
    assert ia._flash_block_k(L) == 256 and ia.static_core_takes_flash(L, C)
    tq = list(map(_t, qkv))
    got = ia.int8_flash_attention_static(*tq, torch.tensor(scal), _t(s), _t(z), 8, scale=C ** -0.5)
    worst, frac = _code_diff(got.numpy(), want)
    assert worst <= 1 and frac <= 1e-2, (worst, frac)
    routed = ia.fused_int8_attention_static(*tq, *(torch.tensor(x) for x in scal), _t(s), _t(z), 8, scale=C ** -0.5)
    assert torch.equal(routed, got)
    # the whole-softmax reference (JAX's oracle of the streaming kernel) is within the same bound
    full = ia.fused_int8_attention_static_reference(*tq, *(torch.tensor(x) for x in scal), _t(s), _t(z), 8,
                                                    scale=C ** -0.5)
    worst, frac = _code_diff(got.numpy(), full.numpy())
    assert worst <= 1 and frac <= 1e-2, (worst, frac)


@pytest.mark.parametrize("L,C,fits,flash", [
    (256, 256, True, False), (16, 512, True, False), (1024, 256, False, False),
    (4096, 128, False, True), (2304, 128, False, True), (1024, 128, False, False),
    (144, 128, True, False), (1032, 256, False, False),
])
def test_routing_predicates_match_jax(L, C, fits, flash):
    """`fused_attention_block_fits` is JAX's, and the static core goes on to
    K10 where JAX's dispatcher does (its gate, read off the JAX source: the
    online softmax rounds differently, so the split is part of the result)."""
    assert ia.fused_attention_block_fits(L, C) == j_i8.fused_attention_block_fits(L, C) == fits
    assert ia.FUSED_ATTN_VMEM_BUDGET == j_i8.FUSED_ATTN_VMEM_BUDGET
    assert ia.static_core_takes_flash(L, C) == flash


# ---------------------------------------------------------------------------
# K3's int8 core
# ---------------------------------------------------------------------------


def test_k3_int8_core_matches_jax():
    """`fused_attention_block(int8_core=True)` against JAX's kernel at (2, 64,
    128), bf16 residual.  Measured: equal."""
    B, L, C = 2, 64, 128
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, L, C)) * 2 + 0.3).astype(ml_dtypes.bfloat16)
    gn = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)

    def quant(a_bit, r):
        return np.full(C, (2 ** a_bit - 1) / (2 * r), np.float32), np.zeros(C, np.float32), a_bit

    def weights():
        return (rng.integers(-8, 8, (C, C)).astype(np.int8), np.abs(5e-5 * rng.standard_normal(C) + 2e-4).astype(np.float32),
                (0.1 * rng.standard_normal(C)).astype(np.float32))

    qkv_quant, qkv_w, o_quant, o_w = [quant(8, 4), quant(6, 4), quant(8, 4)], [weights() for _ in range(3)], quant(8, 3), weights()

    def conv(tree, f):
        return [tuple(f(a) if isinstance(a, np.ndarray) else a for a in item) for item in tree]

    want = {}
    for core in (True, False):
        want[core] = np.asarray(j_i8.fused_attention_block(
            jnp.asarray(x), *map(jnp.asarray, gn), conv(qkv_quant, jnp.asarray), conv(qkv_w, jnp.asarray),
            conv([o_quant], jnp.asarray)[0], conv([o_w], jnp.asarray)[0], scale=C ** -0.5, int8_core=core,
            interpret=True)).astype(np.float32)
    got = ia.fused_attention_block(_t(x), *map(_t, gn), conv(qkv_quant, _t), conv(qkv_w, _t), conv([o_quant], _t)[0],
                                   conv([o_w], _t)[0], scale=C ** -0.5, int8_core=True)
    fig = checks.compare("K3", got, torch.from_numpy(want[True]))
    assert fig["ok"], fig
    assert not np.array_equal(want[True], want[False])  # the int8 core is not the f32 core


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(32, 16), resolution=32, dropout=0.0)
SEQ = [0, 500]
B = 2
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")
SETTINGS = {"static": dict(attn_int8=True, ranges=True), "dynamic": dict(attn_int8=True, ranges=False),
            "f32": dict(attn_int8=False, ranges=False)}
COMPOSED = ["down.0.attn.0", "up.0.attn.0", "up.0.attn.1"]  # 32x32, L = 1024, C = 128
WHOLE = ["down.1.attn.0", "mid.attn_1", "up.1.attn.0", "up.1.attn.1"]  # 16x16, L = 256, C = 256


@pytest.fixture(scope="module")
def chain():
    """The JAX chain on the toy: FP teacher (K11 at its three 32x32 sites),
    stage-1 calibration with the attention ranges (each attention
    projection's input and output absmax recorded from a second, eager
    calibration forward), the fold, and one serving step per attention
    setting with every attention site's input and output recorded."""
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(0)
    R = TOY["resolution"]
    x_small = rng.standard_normal((B, R, R, 3)).astype(np.float32)
    x = rng.standard_normal((B, R, R, 3)).astype(np.float32)
    _, traj, _ = j_ddim_sample(lambda xt, t, i: j_unet_apply(jparams, jcfg, xt, t), jnp.asarray(x_small), SEQ, betas,
                               keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x_small)[None], traj[:-1]], axis=0)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs0 = jq.init_state(len(SEQ))
    jqs, jar = j_calibrate_ranges(jq, jparams, jqs0, xs_in, SEQ, first=True, return_attn_ranges=True)

    proj_io = []  # (step, name, conv input, output absmax) of step 0's attention projections
    one_conv = jax.jit(j_calibrate_one_conv, static_argnums=(2, 3, 4))

    def conv_apply(name, xin, p, *, stride=1, padding="SAME"):
        _upd, xq = one_conv(xin, jqs0[name], jq.policy[name], 0, True)
        out = j_conv2d(xq, p, stride=stride, padding=padding)
        if _is_attn_proj(name):
            proj_io.append((name, np.asarray(xin), float(jnp.abs(out).max())))
        return out

    j_unet_apply(jparams, jcfg, xs_in[0], jnp.full((B,), float(SEQ[-1])), conv_apply=conv_apply)

    jrt = js.prepare_serving_runtime(jq, jparams, jqs)
    t = np.full((B,), 500.0, np.float32)
    eps, sites, saved = {}, {}, js._attn_fused
    for name, kw in SETTINGS.items():
        sites[name] = []

        def record(site, p, h_res, *args, _rec=sites[name]):
            out = saved(site, p, h_res, *args)
            _rec.append((site, np.asarray(h_res), np.asarray(out)))
            return out

        js._attn_fused = record
        try:
            fn = js.serving_model_fn(jq, jrt, jparams, jqs, residual_dtype=jnp.bfloat16, attn_int8=kw["attn_int8"],
                                     attn_ranges=jar if kw["ranges"] else None)
            eps[name] = np.asarray(fn(jnp.asarray(x), jnp.asarray(t), 0))
        finally:
            js._attn_fused = saved
    runtime = {k: ServingLayer(*(torch.tensor(np.asarray(a)) for a in (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp)))
               for k, v in jrt.items()}
    qs_np = {k: {f: np.asarray(getattr(v, f)) for f in FIELDS} for k, v in jqs.items()}
    return dict(params=from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                qstates=from_jax_qstates(qs_np, device="cpu"), runtime=runtime,
                attn_ranges=from_jax_attn_ranges({k: np.asarray(a) for k, a in jar.items()}, device="cpu"),
                jar={k: np.asarray(a) for k, a in jar.items()}, xs_in=np.asarray(xs_in), proj_io=proj_io,
                x=x, t=t, eps=eps, sites=sites)


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8)


def _flags(chain, setting):
    kw = SETTINGS[setting]
    return dict(attn_int8=kw["attn_int8"], attn_ranges=chain["attn_ranges"] if kw["ranges"] else None)


def test_attn_ranges_match_jax(chain):
    """`calibrate_ranges(return_attn_ranges=True)`: JAX's keys, shape [S];
    each projection's output absmax, given the conv input JAX's calibration
    forward gave it, within 1e-5 relative of JAX's (measured: equal).  Over
    the port's own forward the ranges land within 5e-2 of JAX's (measured at
    most 1.2e-2: upstream fake-quant codes flip, ROADMAP Queue 3)."""
    cfg, q = _port()
    qs0 = q.init_state(len(SEQ), "cpu")
    assert len(chain["proj_io"]) == 3 * len(COMPOSED + WHOLE)
    for name, xin, want in chain["proj_io"]:
        _upd, xq = _calibrate_one_conv(_t(xin), qs0[name], q.policy[name], 0, True)
        got = conv2d(xq, _node(chain["params"], name)).abs().max().item()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    _qs, ar = calibrate_ranges(q, chain["params"], qs0, torch.from_numpy(chain["xs_in"]), SEQ, return_attn_ranges=True)
    assert sorted(ar) == sorted(chain["jar"]) == sorted(f"{s}.{k}" for s in COMPOSED + WHOLE for k in ("q", "k", "v"))
    for name, a in ar.items():
        assert tuple(a.shape) == (len(SEQ),) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), chain["jar"][name], rtol=5e-2, err_msg=name)


def _node(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return tree


# One serving step against JAX's, mean relative error; measured static 2.3e-2, dynamic 2.4e-2, f32 2.2e-2: a few
# int8 codes on rounding ties go the other way (GroupNorm rsqrt vs 1/sqrt, f32 sums in another order) and the
# chained quantizers carry them to the output, as on the other toys (tests/test_torch_levers.py holds its step
# to the same 5e-2); every attention site replayed on JAX's own inputs meets its kernel's tolerance (below).
STEP_BOUND = 5e-2


@pytest.mark.parametrize("setting", SETTINGS)
def test_attention_step_matches_jax(chain, setting):
    """One serving_unet_apply under the attention setting, with JAX's qstates,
    fold and attention ranges, against JAX's serving forward."""
    cfg, q = _port()
    eps = serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"], torch.from_numpy(chain["x"]),
                             torch.from_numpy(chain["t"]), 0, residual_dtype=torch.bfloat16, **_flags(chain, setting))
    assert eps.shape == chain["eps"][setting].shape and torch.isfinite(eps).all()
    rel = _rel(eps.numpy(), chain["eps"][setting])
    assert rel < STEP_BOUND, rel


@pytest.mark.parametrize("setting", SETTINGS)
def test_attention_sites_match_jax_teacher_forced(chain, setting):
    """Every attention site of JAX's serving step, replayed by the port's
    `_attn_fused` on JAX's own input: the bf16 residual out within K3's
    tolerance (measured: mean rel at most 7.9e-6, at least 99.93% within 1
    bf16 ulp, in every setting), through the cores the plan names."""
    cfg, q = _port()
    rt_i = srv.gather_step(chain["runtime"], 0)
    flags = _flags(chain, setting)
    ar_i = None if flags["attn_ranges"] is None else {k: a[0] for k, a in flags["attn_ranges"].items()}
    calls = []
    saved = {n: getattr(srv, n) for n in ("fused_attention_block", "fused_int8_attention",
                                          "fused_int8_attention_static", "head_attention")}
    try:
        for n, fn in saved.items():
            setattr(srv, n, lambda *a, _n=n, _fn=fn, **k: (calls.append((_n, k.get("int8_core"))), _fn(*a, **k))[1])
        assert [s for s, _h, _o in chain["sites"][setting]] == sorted(COMPOSED + WHOLE, key=_visit_order)
        for site, h_res, want in chain["sites"][setting]:
            got = srv._attn_fused(site, _node(chain["params"], site), _t(h_res), rt_i, q, torch.bfloat16,
                                  attn_int8=flags["attn_int8"], ar_i=ar_i)
            fig = checks.compare("K3", got, _t(want))
            assert fig["ok"], (site, fig)
    finally:
        for n, fn in saved.items():
            setattr(srv, n, fn)
    core = {"static": "fused_int8_attention_static", "dynamic": "fused_int8_attention", "f32": "head_attention"}
    int8 = setting != "f32"
    assert calls == [(core[setting], None) if s in COMPOSED else ("fused_attention_block", int8)
                     for s, _h, _o in chain["sites"][setting]]
    plan = checks.expected_launches(cfg, 1, B, **flags)
    want = {"static": ("K9", 3), "dynamic": ("K8", 3), "f32": ("K11", 3)}[setting]
    assert plan[want[0]] == want[1] and plan["K3"] == 4 and plan["K3.int8_core"] == (4 if int8 else 0)
    assert plan["K5"] == 5 + 4 * 3  # five nin_shortcuts, and four 1x1 projections a composed site


def _visit_order(site):
    order = ["down.0.attn.0", "down.1.attn.0", "mid.attn_1", "up.1.attn.0", "up.1.attn.1", "up.0.attn.0", "up.0.attn.1"]
    return order.index(site)


def test_ranges_that_miss_a_site_fall_back_to_the_dynamic_core(chain):
    """As in JAX (`_attn_fused`): a site whose q, k or v is not in
    `attn_ranges` runs the dynamic core, the others the static one; nothing
    raises.  Told by which core each composed site calls."""
    cfg, q = _port()
    ranges = {k: a for k, a in chain["attn_ranges"].items() if k != "up.0.attn.0.k"}
    calls = []
    saved = srv.fused_int8_attention, srv.fused_int8_attention_static
    try:
        srv.fused_int8_attention = lambda *a, **k: (calls.append("dynamic"), saved[0](*a, **k))[1]
        srv.fused_int8_attention_static = lambda *a, **k: (calls.append("static"), saved[1](*a, **k))[1]
        eps = serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                                 torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0, attn_ranges=ranges,
                                 residual_dtype=torch.bfloat16)
    finally:
        srv.fused_int8_attention, srv.fused_int8_attention_static = saved
    assert calls == ["static", "dynamic", "static"] and torch.isfinite(eps).all()
    plan = checks.expected_launches(cfg, 1, B, attn_int8=True, attn_ranges=ranges)
    assert (plan["K9"], plan["K8"]) == (2, 1)
    # JAX's forward makes the same choice: its step with these ranges differs from the all-static one
    assert _rel(eps.numpy(), chain["eps"]["static"]) < STEP_BOUND


def test_int8_cores_track_the_f32_core_as_in_jax(chain):
    """The int8 cores are a step away from the f32 core, in the port as in
    JAX (JAX's own tests hold that step to 2e-2 dynamic, 3e-2 static on its
    toy), and by a like amount (measured 2.5e-2 for both cores, in both)."""
    cfg, q = _port()
    out = {s: serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                                 torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0,
                                 residual_dtype=torch.bfloat16, **_flags(chain, s)).numpy() for s in SETTINGS}
    for s in ("static", "dynamic"):
        port, ref = _rel(out[s], out["f32"]), _rel(chain["eps"][s], chain["eps"]["f32"])
        assert port > 0 and ref > 0 and 0.2 < port / ref < 5, (s, port, ref)


def test_attn_fused_routes_a_48x48_site_to_k10():
    """One attention site at 48x48 (L = 2304, C = 128) with ranges: over JAX's
    budget and on the 256 grid, so it streams through K10 with key blocks of
    256, in the port as in JAX's `_attn_fused` on the same fold."""
    H, C = 48, 128
    rng = np.random.default_rng(5)
    names = [f"a.{k}" for k in ("q", "k", "v", "proj_out")]
    lay = {n: dict(gq=rng.integers(-8, 8, (C, C)).astype(np.int8),
                   inv_ws=np.abs(5e-5 * rng.standard_normal(C) + 2e-4).astype(np.float32),
                   zcbias=(0.1 * rng.standard_normal(C)).astype(np.float32),
                   act_scale=np.full(C, 255 / 8.0, np.float32), act_zp=np.zeros(C, np.float32)) for n in names}
    lay["a.proj_out"]["act_scale"] = np.full(C, 255 / 4.0, np.float32)
    p = {"norm": {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
                  "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}}
    h = (rng.standard_normal((1, H, H, C)) * 2 + 0.3).astype(ml_dtypes.bfloat16)
    ar = {f"a.{k}": np.float32(r) for k, r in (("q", 2.5), ("k", 2.5), ("v", 2.0))}
    qunet = types.SimpleNamespace(policy={n: types.SimpleNamespace(a_bit=6 if n == "a.k" else 8) for n in names})

    jrt = {n: js.ServingLayer(**{f: jnp.asarray(a) for f, a in d.items()}) for n, d in lay.items()}
    want = js._attn_fused("a", jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(h), jrt, qunet, None, 0,
                          jnp.bfloat16, True, {k: jnp.asarray(a) for k, a in ar.items()})
    calls, saved = [], ia.int8_flash_attention_static
    try:
        ia.int8_flash_attention_static = lambda *a, **k: (calls.append(a[0].shape), saved(*a, **k))[1]
        got = srv._attn_fused("a", jax.tree_util.tree_map(_t, p), _t(h),
                              {n: ServingLayer(**{f: _t(a) for f, a in d.items()}) for n, d in lay.items()}, qunet,
                              torch.bfloat16, attn_int8=True, ar_i={k: torch.tensor(a) for k, a in ar.items()})
    finally:
        ia.int8_flash_attention_static = saved
    assert calls == [(1, H * H, C)]
    fig = checks.compare("K3", got, _t(np.asarray(want)))  # measured: mean rel 3.5e-7, 99.997% within 1 bf16 ulp
    assert fig["ok"], fig
