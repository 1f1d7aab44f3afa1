"""PyTorch port vs the JAX package: the serving forward and the serving DDIM
sampler under the three fusion levers, `entry_pallas` (K4), `boundary_fusion`
(K7) and `resblock_pallas` (K12), each alone and all three together, on a toy
UNet at W4A8; and the launch plan `ops.checks.lever_plan` derives from a
config against the sites the forward visits.

The JAX side runs once per module (calibration, fold, then per lever setting
one serving step and a 2-step sampler), its Pallas kernels in interpret
mode, on the toy of tests/test_torch_serving.py: K4 at six entries with
`entry_pallas`, K7 at down.1.block.0 feeding mid.block_1, K12 at
down.0.block.0 and mid.block_2.  The port runs every GroupNorm entry that
K4 takes on K4 at either value of `entry_pallas`; each setting's JAX side
runs under the port's flags, JAX's XLA entry where `entry_pallas` is off
(on this toy it gives the codes of K4's plain version at every entry).
The launch-plan tests run the port alone on a deeper toy that has what the
plan's rules need: two blocks a level (a K7 exit that feeds the next norm1,
and two in a row into mid.block_1), an identity block at 8x8 with 256
channels (where JAX's conv policy lets K12 in) and attention at 8x8 (which
resets the carried sums)."""
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
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import calibrate_ranges as j_calibrate_ranges
from attentiondm_tpu.quant import int8_serving as js
from attentiondm_tpu.quant.int8_serving import prepare_serving_runtime as j_prepare
from attentiondm_tpu.quant.int8_serving import serving_ddim_sampler as j_sampler
from attentiondm_tpu.quant.int8_serving import serving_model_fn as j_model_fn
from attentiondm_tpu_torch.config import load_config
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_init
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.quant import int8_serving as srv
from attentiondm_tpu_torch.quant.int8_serving import (
    ServingLayer,
    prepare_serving_runtime,
    serving_ddim_sampler,
    serving_unet_apply,
)
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
DEEP_TOY = dict(ch=128, ch_mult=(1, 2, 2), num_res_blocks=2, attn_resolutions=(8,), resolution=16, dropout=0.0)
SEQ = [0, 500]
B = 2
ALL = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
# "all" for the lever alone: JAX's conv policy (resblock_pallas=True) lets no block of this toy in
LEVERS = {
    "entry_pallas": dict(entry_pallas=True),
    "boundary_fusion": dict(boundary_fusion=True),
    "resblock_pallas": dict(resblock_pallas="all"),
    "all_three": ALL,
}
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _jax_chain():
    """The JAX chain (teacher, stage-1 calibration, fold), one serving step
    and a 2-step sampler per lever setting, and the port's inputs."""
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(0)
    R = TOY["resolution"]
    x_small = rng.standard_normal((B, R, R, 3)).astype(np.float32)
    x = rng.standard_normal((B, R, R, 3)).astype(np.float32)
    _, traj, _ = j_ddim_sample(lambda xt, t, i: j_unet_apply(jparams, jcfg, xt, t), jnp.asarray(x_small),
                               SEQ, betas, keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x_small)[None], traj[:-1]], axis=0)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs = j_calibrate_ranges(jq, jparams, jq.init_state(len(SEQ)), xs_in, SEQ, first=True)
    jrt = j_prepare(jq, jparams, jqs)
    t = np.full((B,), 500.0, np.float32)
    common = dict(residual_dtype=jnp.bfloat16, attn_int8=False)
    eps, sample = {}, {}
    for name, kw in {"off": {}, **LEVERS}.items():
        kw = {**common, **kw}
        eps[name] = np.asarray(j_model_fn(jq, jrt, jparams, jqs, **kw)(jnp.asarray(x), jnp.asarray(t), 0))
        if name != "off":
            sample[name] = np.asarray(j_sampler(jq, jparams, jqs, SEQ, betas, runtime=jrt, **kw)(jnp.asarray(x)))
    runtime = {k: ServingLayer(*(torch.tensor(np.asarray(a)) for a in
                                 (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp)))
               for k, v in jrt.items()}
    qs_np = {k: {f: np.asarray(getattr(v, f)) for f in FIELDS} for k, v in jqs.items()}
    return dict(params=from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                qstates=from_jax_qstates(qs_np, device="cpu"), runtime=runtime, x=x, t=t, eps=eps, sample=sample,
                jparams=jparams, jq=jq, jrt=jrt)


@pytest.fixture(scope="module")
def chain():
    return _jax_chain()


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")


def _step(chain, **kw):
    cfg, q, _ = _port()
    return serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                              torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0, residual_dtype=torch.bfloat16, attn_int8=False,
                              **kw)


# One serving step against JAX's, mean relative error.  2e-3 is the levers-off bound of
# tests/test_torch_serving.py (measured 0.0 here for these three: bit-equal).  With boundary_fusion
# alone the step lands 1.4e-2 from JAX's whole-step jit although every resblock of that step,
# replayed in JAX on the port's own inputs, is equal to the bit
# (test_lever_blocks_match_jax_teacher_forced): one int8 code on a rounding tie outside the
# blocks goes the other way and the chained quantizers carry it to the output.  The bound there
# is the size of the lever's own effect on this toy (JAX with the lever against JAX without: 3.1e-2).
STEP_BOUND = {"entry_pallas": 2e-3, "resblock_pallas": 2e-3, "all_three": 2e-3, "boundary_fusion": 5e-2}


@pytest.mark.parametrize("name", LEVERS)
def test_lever_step_matches_jax(chain, name):
    """One serving_unet_apply under the lever(s), with JAX's qstates and
    fold, against JAX's serving forward under the same flags."""
    eps = _step(chain, **LEVERS[name])
    assert eps.shape == chain["eps"][name].shape and torch.isfinite(eps).all()
    rel = _rel(eps.numpy(), chain["eps"][name])
    assert rel < STEP_BOUND[name], rel


def _jnode(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return tree


@pytest.mark.parametrize("name", LEVERS)
def test_lever_blocks_match_jax_teacher_forced(chain, name):
    """Every resblock of one port step under the lever(s), replayed by JAX's
    `_resblock_fused` on the port's own inputs (residual, temb, carried sums)
    with the same flags: outputs within 1 bf16 ulp (measured: equal), K7's
    sums within 1e-5 relative.  Unlike the whole step this cannot be moved by
    a tie code upstream, so it holds the routing and every lever kernel's
    plain version to JAX's."""
    calls, orig = [], srv._resblock_fused

    def spy(bname, p, h_res, temb_act, rt_i, qunet, res_dtype, **kw):
        out = orig(bname, p, h_res, temb_act, rt_i, qunet, res_dtype, **kw)
        calls.append((bname, h_res, temb_act, kw, out))
        return out

    srv._resblock_fused = spy
    try:
        _step(chain, **LEVERS[name])
    finally:
        srv._resblock_fused = orig
    jrt_i = {k: js._unpack_layer(v) for k, v in js.gather_step(chain["jrt"], 0).items()}
    sums_seen = 0
    for bname, h_res, temb_act, kw, (out, sums) in calls:
        es = kw.get("entry_sums")
        jout, jsums = js._resblock_fused(
            bname, _jnode(chain["jparams"], bname), jnp.asarray(h_res.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(temb_act.numpy()), jrt_i, chain["jq"], None, 0, jnp.bfloat16,
            entry_sums=None if es is None else jnp.asarray(es.numpy()),
            want_exit_stats=kw["want_exit_stats"] if "want_exit_stats" in kw else False, dot_bf16=True,
            entry_pallas=LEVERS[name].get("entry_pallas", False), resblock_pallas=kw["resblock_pallas"])
        got, want = out.float().numpy(), np.asarray(jout).astype(np.float32)
        assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all(), bname
        assert (sums is None) == (jsums is None), bname
        if sums is not None:
            np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5, err_msg=bname)
            sums_seen += 1
    assert len(calls) == 8 and sums_seen == (1 if "boundary_fusion" in LEVERS[name] else 0)


@pytest.mark.parametrize("name", LEVERS)
def test_lever_sampler_matches_jax(chain, name):
    """The 2-step serving sampler under the lever(s), sharing JAX's fold
    through `runtime=` as JAX's lever grid does."""
    cfg, q, sched = _port()
    sample = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas,
                                  runtime=chain["runtime"], residual_dtype=torch.bfloat16, attn_int8=False,
                                  **LEVERS[name])
    out = sample(torch.from_numpy(chain["x"]))
    assert torch.isfinite(out).all()
    assert _rel(out.numpy(), chain["sample"][name]) < 1e-2  # the levers-off sampler's bound


def test_levers_change_the_step_as_in_jax(chain):
    """The levers are not a no-op: K7's consumer normalizes with sum /
    sum-of-squares statistics and K12 keeps conv1's output in f32, so each
    moves the output, in the port as in JAX, and by a like amount.
    `entry_pallas` is `conv_pallas`'s like: the same output and launches at
    either value, the step within the lever's bound of JAX's K4 step."""
    off = _step(chain).numpy()
    for name in ("boundary_fusion", "resblock_pallas", "all_three"):
        port = _rel(_step(chain, **LEVERS[name]).numpy(), off)
        ref = _rel(chain["eps"][name], chain["eps"]["off"])
        assert port > 0 and ref > 0 and 0.2 < port / ref < 5, (name, port, ref)
    assert np.array_equal(_step(chain, entry_pallas=True).numpy(), off)
    assert _rel(off, chain["eps"]["entry_pallas"]) < STEP_BOUND["entry_pallas"]
    cfg = UNetConfig(**TOY)
    assert checks.expected_launches(cfg, 1, B, entry_pallas=True) == checks.expected_launches(cfg, 1, B)


@pytest.fixture(scope="module")
def deep():
    """The deeper toy, port only: seeded weights, the ranges a calibration
    would leave ([-1, 4] per group), one step's fold."""
    cfg = UNetConfig(**DEEP_TOY)
    params = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, "cpu")
    for st in qstates.values():
        st.group_ranges[..., 0], st.group_ranges[..., 1] = -1.0, 4.0
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 16, 16, 3)).astype(np.float32))
    return dict(cfg=cfg, params=params, q=q, qstates=qstates, runtime=prepare_serving_runtime(q, params, qstates), x=x)


def _visited(deep, levers):
    """(kernel, site shape) of every K4 / K7 / K12 call of one port forward."""
    seen = []
    saved = {n: getattr(srv, n) for n in ("gn_act_quant", "epilogue_residual_gn_stats", "_rb_kernel")}

    def spy(kind, fn):
        def call(x, *a, **k):
            C = x.shape[-1]
            seen.append((kind, x.shape[1] if kind == "K12" else x.numel() // (x.shape[0] * C), C))
            return fn(x, *a, **k)
        return call

    try:
        for kind, n in (("K4", "gn_act_quant"), ("K7", "epilogue_residual_gn_stats"), ("K12", "_rb_kernel")):
            setattr(srv, n, spy(kind, saved[n]))
        eps = serving_unet_apply(deep["params"], deep["cfg"], deep["q"], deep["runtime"], deep["qstates"], deep["x"],
                                 torch.full((B,), 500.0), 0, residual_dtype=torch.bfloat16, attn_int8=False,
                                 **levers)
    finally:
        for n, fn in saved.items():
            setattr(srv, n, fn)
    assert torch.isfinite(eps).all()
    return sorted(seen)


def test_k7_reads_the_bf16_residual(deep):
    """At identity-shortcut exits K7 takes the bf16 residual stream itself,
    not an f32 copy of it, and the step gives the bits it gave with the f32
    copy (the bf16 -> f32 conversion is exact)."""
    got = []
    k7 = srv.epilogue_residual_gn_stats

    def spy(dot, inv_ws, zcbias, x_res, **kw):
        got.append(x_res.dtype)
        return k7(dot, inv_ws, zcbias, x_res, **kw)

    def with_f32_copy(dot, inv_ws, zcbias, x_res, **kw):
        return k7(dot, inv_ws, zcbias, x_res.to(torch.float32), **kw)

    def step():
        return serving_unet_apply(deep["params"], deep["cfg"], deep["q"], deep["runtime"], deep["qstates"],
                                  deep["x"], torch.full((B,), 500.0), 0, residual_dtype=torch.bfloat16, attn_int8=False,
                                  boundary_fusion=True)

    try:
        srv.epilogue_residual_gn_stats = spy
        eps = step()
        srv.epilogue_residual_gn_stats = with_f32_copy
        before = step()
    finally:
        srv.epilogue_residual_gn_stats = k7
    # the deep toy's three K7 exits all have an identity shortcut
    assert got == [torch.bfloat16] * 3
    assert torch.equal(eps, before)


PLAN_LEVERS = {"off": {}, **LEVERS, "resblock_pallas_gated": dict(resblock_pallas=True)}


@pytest.mark.parametrize("name", PLAN_LEVERS)
def test_lever_plan_matches_the_forward(deep, name):
    """`lever_plan` (config and predicates only) names exactly the sites the
    forward sends through K4, K7 and K12."""
    levers = PLAN_LEVERS[name]
    plan = checks.lever_plan(deep["cfg"], B, **levers)
    want = sorted((kind, *shape) for kind, sites in plan.items() for _site, *shape in sites)
    assert _visited(deep, levers) == want
    if name == "all_three":
        assert [s for s, *_ in plan["K7"]] == ["down.0.block.0", "down.2.block.0", "down.2.block.1"]
        assert [s for s, *_ in plan["K12"]] == ["down.1.block.1", "mid.block_2"]
    if name == "resblock_pallas_gated":  # JAX's conv policy: not (128, 128), not below 8x8 under 512 channels
        assert [s for s, *_ in plan["K12"]] == ["down.1.block.1"]


ALL = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
# K7 sites by JAX's `want` rule and `epilogue_residual_gn_stats_fits` (HW * N * 16 <= 4 MiB); K12 sites next
# to them with "all"; per-step counts of every kernel with the three levers
FULL_WIDTH = {
    "cifar10": (128, ["down.0.block.0", "down.2.block.0", "down.3.block.0", "down.3.block.1"],
                ["down.1.block.1", "mid.block_2"],
                {"K1": 60, "K2": 20, "K6": 0, "K3": 6, "K5": 13, "K13": 4, "K4": 17, "K7": 4, "K12": 2}),
    "church": (32, ["down.3.block.0", "down.5.block.0", "down.5.block.1"], ["down.4.block.1", "mid.block_2"],
               {"K1": 91, "K2": 20, "K6": 10, "K3": 6, "K5": 20, "K13": 6, "K4": 28, "K7": 3, "K12": 2}),
}


@pytest.mark.parametrize("model", FULL_WIDTH)
def test_lever_plan_at_full_width(model):
    """The launch plan of the CIFAR-10 and church configs (structure only):
    the K7 and K12 sites, the counts with all three levers, each lever alone,
    and what K12 takes from K1 and K2."""
    batch, k7, k12, counts = FULL_WIDTH[model]
    # the f32 attention core (bench.py's flag): no int8 core, and these models have no composed attention site
    counts = {**counts, **{k: 0 for k in ("K3.int8_core", "K8", "K9", "K10", "K11")}}
    expected_launches = functools.partial(checks.expected_launches, attn_int8=False)
    cfg = UNetConfig() if model == "cifar10" else UNetConfig.from_config(load_config("church.yml"))
    plan = checks.lever_plan(cfg, batch, **ALL)
    assert [s for s, *_ in plan["K7"]] == k7 and [s for s, *_ in plan["K12"]] == k12
    assert expected_launches(cfg, 1, batch, **ALL) == counts
    off = expected_launches(cfg, 1, batch)
    # levers off: K4 at every resblock and conv_out entry (church's 16 past 32 windows on the blocked form);
    # entry_pallas moves nothing
    entries = 1 + sum(1 for name, *_ in checks.conv_plan(cfg)[0] if name.endswith(".conv1"))
    assert (off["K4"], off["K7"], off["K12"]) == (entries, 0, 0) and entries == {"cifar10": 23, "church": 33}[model]
    assert expected_launches(cfg, 1, batch, entry_pallas=True) == off
    # resblock_pallas alone: each K12 block takes two K1 convs and one K2 with it
    rb = expected_launches(cfg, 1, batch, resblock_pallas="all")
    assert rb["K1"] == off["K1"] - 2 * rb["K12"] and rb["K2"] + rb["K6"] == off["K2"] + off["K6"] - rb["K12"]
    assert rb["K12"] == {"cifar10": 9, "church": 7}[model]
    assert expected_launches(cfg, 1, batch, resblock_pallas=True)["K12"] == {"cifar10": 3, "church": 7}[model]
    assert expected_launches(cfg, 3, batch, **ALL) == {k: 3 * n for k, n in counts.items()}
    # the default attention flags (attn_int8=True) only switch K3's six launches to the int8 core
    assert checks.expected_launches(cfg, 1, batch, **ALL) == {**counts, "K3.int8_core": 6}


# ---------------------------------------------------------------------------
# the entry's routing: K4 wherever it takes the shape
# ---------------------------------------------------------------------------


def _entry_inputs(shape, n_out, seed):
    """A residual (one channel group at offset 40), GroupNorm params and n_out 8-bit quantizations (output i
    at a range shifted by i / 2), as the card's K4 checks draw them."""
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    x[..., :C // 32] += 40.0
    gn = {"scale": torch.from_numpy(rng.normal(1.0, 0.1, C).astype(np.float32)),
          "bias": torch.from_numpy(rng.normal(0.0, 0.1, C).astype(np.float32))}
    sc = 255 / 4.5
    qp = [(torch.full((C,), sc), torch.full((C,), round(sc * (-0.5 - i / 2)) + 128.0), 8) for i in range(n_out)]
    return torch.from_numpy(x), gn, qp


@pytest.mark.parametrize("shape,n_out,act,sums,route", [
    ((2, 8, 8, 128), 1, "swish", False, "K4"),  # the image form
    ((2, 40, 40, 128), 1, "swish", False, "K4"),  # past 32 windows: the blocked form
    ((2, 40, 40, 160), 1, "swish", False, "K4"),  # past 32 windows off the 128 grid: the cluster form
    ((2, 40, 40, 256), 3, "none", False, "K4"),  # the composed attention's entry
    ((2, 40, 40, 128), 1, "swish", True, "plain"),  # K7's sums: the plain entry is one pass already
    ((1, 4, 4, 2304), 1, "swish", False, "plain"),  # past K4's 2048 channels
    ((1, 40, 40, 1152), 3, "none", False, "plain"),  # past 1024 channels beyond 32 windows
], ids=str)
def test_entry_routes_by_what_k4_takes(monkeypatch, shape, n_out, act, sums, route):
    """`_entry_gn_quant` sends an entry to K4 (`gn_act_quant`, its plain
    version on the CPU) wherever `gn_act_quant_takes` admits the shape, and
    keeps `gn_act_quant_xla` with K7's sums or where no form takes it; its
    output is the chosen path's."""
    from attentiondm_tpu_torch.ops import fused_gn as fg

    x, gn, qp = _entry_inputs(shape, n_out, sum(shape) + n_out)
    B, C = shape[0], shape[-1]
    assert fg.gn_act_quant_takes(B, x.numel() // (B * C), C, x.dtype, n_out) == (route == "K4" or sums)
    called = []
    for name in ("gn_act_quant", "gn_act_quant_xla"):
        monkeypatch.setattr(srv, name,
                            lambda *a, _fn=getattr(srv, name), _n=name, **k: called.append(_n) or _fn(*a, **k))
    s = None
    if sums:
        xg = x.reshape(B, -1, 32, C // 32)
        s = torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))], 1)
    got = srv._entry_gn_quant(x, gn, qp, act=act, sums=s)
    assert called == (["gn_act_quant"] if route == "K4" else ["gn_act_quant_xla"])
    want = (fg.gn_act_quant_ref(x, gn["scale"], gn["bias"], qp, act=act) if route == "K4"
            else srv.gn_act_quant_xla(x, gn, qp, act=act, sums=s))
    assert len(got) == n_out and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n_out,act", [(1, "swish"), (1, "none"), (3, "swish"), (3, "none")])
@pytest.mark.parametrize("shape", [(2, 40, 40, 128), (1, 48, 48, 256), (2, 33, 32, 384)], ids=str)
def test_k4_entry_within_the_bound_of_the_plain_entry(shape, n_out, act):
    """Past 32 windows (church's blocked-form entries, scaled down), what an
    entry computes on the CPU now (K4's plain version: E[x^2] - mu^2 in
    `window_sum`'s order, h * (1 / (1 + exp(-h)))) against what it computed
    before (`gn_act_quant_xla`: torch's two-pass variance and sigmoid):
    within `STEP_BOUND["entry_pallas"]` (mean relative difference of the
    codes), and no int8 code more than 1 LSB apart."""
    from attentiondm_tpu_torch.ops import fused_gn as fg

    x, gn, qp = _entry_inputs(shape, n_out, sum(shape) + 7 * n_out)
    got = fg.gn_act_quant_ref(x, gn["scale"], gn["bias"], qp, act=act)
    want = srv.gn_act_quant_xla(x, gn, qp, act=act)
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        assert d.max().item() <= 1
        assert (d.mean() / w.float().abs().mean()).item() < STEP_BOUND["entry_pallas"]


def test_entry_pallas_values_route_alike(deep):
    """`entry_pallas` takes JAX's values, True and False, and either gives
    the same K4 sites (every entry of the deep toy) and the same output; any
    other value raises, as `conv_pallas`'s do."""
    def step(**kw):
        return serving_unet_apply(deep["params"], deep["cfg"], deep["q"], deep["runtime"], deep["qstates"], deep["x"],
                                  torch.full((B,), 500.0), 0, residual_dtype=torch.bfloat16, attn_int8=False, **kw)

    seen = [_visited(deep, levers) for levers in ({}, dict(entry_pallas=False), dict(entry_pallas=True))]
    assert seen[0] == seen[1] == seen[2]
    entries = 1 + sum(1 for name, *_ in checks.conv_plan(deep["cfg"])[0] if name.endswith(".conv1"))
    assert sum(1 for kind, *_ in seen[0] if kind == "K4") == entries
    assert torch.equal(step(entry_pallas=True), step(entry_pallas=False))
    with pytest.raises(ValueError, match="entry_pallas"):
        step(entry_pallas="all")
