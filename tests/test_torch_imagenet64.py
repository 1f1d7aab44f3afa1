"""PyTorch port vs the JAX package on what ImageNet-64 (`imagenet64.yml`)
adds to the serving path:

- all six beta schedules and both variances, and the imagenet64 config;
- the fold's forms: `pack_int4` (bytes, round trip), rank-1 shared folds
  (`quant/rank1.py`, `_fold_all_steps(rank1=True)`);
- the two kernels at widths no earlier path ran, through their plain
  versions: K3 at C = 1024 (both cores) and K4 at 1536 and 2048 channels;
- the sampler's `step_chunk`, `micro_batch`, `pack_int4` and `rank1` on a
  toy UNet with the cosine schedule: chunked, micro-batched and packed
  samplers equal the plain one to the bit, and each of them and the rank-1
  sampler stays within the toy's bound of JAX's sampler with the same flags;
- the plans that take imagenet64's step on the card (no site refused, the
  launch counts a step).

The JAX side runs once per module (calibration and its samplers), its
Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from attentiondm_tpu.config import load_config as j_load_config
from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion import ddim_sample as j_ddim_sample
from attentiondm_tpu.diffusion.schedules import get_beta_schedule as j_get_beta_schedule
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.ops import fused_gn as jfg
from attentiondm_tpu.ops.int8_attention import fused_attention_block as j_fused_attention_block
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import calibrate_ranges as j_calibrate_ranges
from attentiondm_tpu.quant import rank1 as jr1
from attentiondm_tpu.quant.int8_runtime import _fold_all_steps as j_fold_all_steps
from attentiondm_tpu.quant.int8_serving import pack_int4 as j_pack_int4
from attentiondm_tpu.quant.int8_serving import serving_ddim_sampler as j_sampler
from attentiondm_tpu_torch.config import load_config
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule, get_beta_schedule
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.ops import fused_gn as fg
from attentiondm_tpu_torch.ops import int8_attention as ia
from attentiondm_tpu_torch.ops.pallas_conv import k_major
from attentiondm_tpu_torch.quant import rank1 as tr1
from attentiondm_tpu_torch.quant.int8_runtime import _fold_all_steps
from attentiondm_tpu_torch.quant.int8_serving import (
    pack_int4,
    prepare_serving_runtime,
    runtime_nbytes,
    serving_ddim_sampler,
    unpack_int4,
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


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX's arrays come back read-only)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = ["quad", "linear", "const", "jsd", "sigmoid", "cosine"]


@pytest.mark.parametrize("var_type", ["fixedlarge", "fixedsmall"])
@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_jax(name, var_type):
    """betas bit-equal in float64, and the float32 tensors equal."""
    kw = dict(beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=1000)
    betas = get_beta_schedule(name, **kw)
    assert betas.dtype == np.float64 and np.array_equal(betas, j_get_beta_schedule(name, **kw))
    sched = DiffusionSchedule.create(name, 1e-4, 0.02, 1000, device="cpu", var_type=var_type)
    jsched = JSchedule.create(name, 1e-4, 0.02, 1000, var_type=var_type)
    for f in ("betas", "alphas_cumprod", "logvar"):
        got = getattr(sched, f)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jsched, f)), err_msg=f)


def test_imagenet64_config_is_the_served_one():
    """imagenet64.yml: 64^2, ch 128, ch_mult 1-2-4-8, 3 res blocks, attention
    at 16^2, the cosine schedule, as JAX reads it."""
    config = load_config("imagenet64.yml")
    cfg = UNetConfig.from_config(config)
    assert cfg == UNetConfig(resolution=64, ch_mult=(1, 2, 4, 8), num_res_blocks=3, attn_resolutions=(16,),
                             dropout=0.0)
    assert config.diffusion.beta_schedule == "cosine" and config.sampling.batch_size == 32
    sched = DiffusionSchedule.from_config(config, device="cpu")
    jsched = JSchedule.from_config(j_load_config("imagenet64.yml"))
    for f in ("betas", "alphas_cumprod", "logvar"):
        np.testing.assert_array_equal(getattr(sched, f).numpy(), np.asarray(getattr(jsched, f)), err_msg=f)
    assert float(sched.betas[-1]) == np.float32(0.999)  # the cosine schedule's clip


# ---------------------------------------------------------------------------
# the imagenet64 step on the card's kernels
# ---------------------------------------------------------------------------

IMAGENET64 = UNetConfig.from_config(load_config("imagenet64.yml"))
LEVERS = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")


@pytest.mark.parametrize("levers", [{}, LEVERS], ids=["levers_off", "three_levers"])
def test_imagenet64_step_is_taken_by_the_kernels(levers):
    """No attention, GroupNorm or resblock site of imagenet64's step at batch
    32 is refused (`serving_ddim_sampler` checks this before step 0 on the
    card), and a step's launches are the counts the chip run checks."""
    assert checks.attention_plan(IMAGENET64, attn_int8=False)["refused"] == []
    assert checks.attention_plan(IMAGENET64)["refused"] == []
    assert checks.gn_refused(IMAGENET64, 32, **levers) == []
    checks.require_gn_kernels(IMAGENET64, "cuda", 32, **levers)
    checks.require_attention_kernels(IMAGENET64, "cuda", attn_int8=False)
    n = checks.expected_launches(IMAGENET64, 1, 32, attn_int8=False, **levers)
    if not levers:
        assert {k: n[k] for k in ("K1", "K2", "K3", "K5", "K13", "K6")} == dict(K1=86, K2=30, K3=8, K5=19, K13=4,
                                                                              K6=0)
        assert sorted(checks.conv_plan(IMAGENET64)[3]) == [(64, 1024)] + [(256, 512)] * 7
    else:
        k4 = {(HW, C) for _s, HW, C in checks.lever_plan(IMAGENET64, 32, **levers)["K4"]}
        assert {(64, 2048), (64, 1536), (256, 1536)} <= k4 and n["K4"] == 23  # 4 past 32 windows: the blocked form


@pytest.mark.parametrize("int8_core", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("L", [1, 16, 64, 65, 128, 246, 256, 512, 513, 1024])
def test_k3_plan_at_c1024(L, int8_core):
    """K3's core at C = 1024 over JAX's whole `fused_attention_block_fits`
    (L up to 246) and on to K3_MAX_L: the plan is the one of the narrower
    widths (no stage holds a [bq, C] tile), within a block's shared memory
    and the two-blocks-an-SM rule; q / k chunks and p.v passes divide C."""
    p = ia.core_plan(L, 1024, int8_core)
    assert ia.k3_takes(L, 1024) and p.smem <= ia.SMEM_PER_BLOCK
    assert p == ia.core_plan(L, 512, int8_core)
    assert 1024 % p.chunk == 0 and 1024 % p.cp == 0 and p.cp // (8 // (p.bq // 16)) <= 64
    assert p.stages == 2 or p.smem <= ia.K3_TWO_BLOCKS
    assert ia.fused_attention_block_fits(L, 1024) == (8 <= L <= 246)


@pytest.mark.parametrize("n_out", [1, 3])
@pytest.mark.parametrize("HW", [16, 64, 256, 400, 1024])
@pytest.mark.parametrize("N", [1152, 1536, 2048])
def test_k4_plans_past_1024_channels(N, HW, n_out):
    """K4's image form past 1024 channels: every plan slices the image into
    whole groups and whole 8-channel vectors within the launch bound and a
    block's shared memory, covers every channel once, and the chosen plan is
    one of them; the cluster form offers none (it stops at 1024), and 2056
    channels have no plan."""
    plans = fg.image_plans(32, HW, N, n_out)
    assert plans and not fg.k2_plans(HW, N, 2, fg.max_threads(n_out))
    cg = N // fg.GROUPS
    for p in plans:
        Ns = N // p["slices"]
        assert N % p["slices"] == 0 and Ns % fg.VEC == 0 and Ns % cg == 0
        assert p["threads"] == Ns // fg.VEC * p["row_groups"] <= fg.max_threads(n_out)
        assert p["smem"] == fg._image_smem(-(-HW // fg.WIN), Ns) <= fg.SMEM_MAX
    assert fg.epilogue_plan(32, HW, N, torch.bfloat16, "K4", n_out) in plans
    assert fg.gn_act_quant_takes(32, HW, N, n_out=n_out)
    assert not fg.gn_act_quant_takes(32, HW, 2056, n_out=n_out)
    assert not fg.gn_act_quant_takes(32, 1056, N, n_out=n_out)  # past 32 windows: the cluster form's 1024


# ---------------------------------------------------------------------------
# K3 at C = 1024 and K4 at 1536 / 2048, plain versions against JAX
# ---------------------------------------------------------------------------


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp."""
    e = np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
    return np.abs(got - want) / 2.0 ** (e - 7)


def _k3_inputs(rng, L, C):
    x = (rng.standard_normal((2, L, C)) * 1.5 + 0.2).astype(ml_dtypes.bfloat16)

    def quant(a_bit, lo, hi):
        rmin, rmax = rng.uniform(lo, lo / 2, C), rng.uniform(hi / 2, hi, C)
        s = ((2 ** a_bit - 1) / (rmax - rmin)).astype(np.float32)
        return s, (np.round(s * rmin) + 2 ** (a_bit - 1)).astype(np.float32), a_bit

    def weights():
        return (rng.integers(-8, 8, (C, C)).astype(np.int8), rng.uniform(5e-5, 1.5e-4, C).astype(np.float32),
                (0.1 * rng.standard_normal(C)).astype(np.float32))

    gn = ((1 + 0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32))
    return x, *gn, [quant(8, -4, 4), quant(6, -4, 4), quant(8, -4, 4)], [weights() for _ in range(3)], \
        quant(8, -3, 3), weights()


def _tree(tree, leaf):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(a, leaf) for a in tree)
    return leaf(tree) if isinstance(tree, np.ndarray) else tree


@pytest.mark.parametrize("int8_core", [False, True], ids=["f32", "int8"])
def test_k3_at_c1024_matches_jax(int8_core):
    """imagenet64's 8^2 attention block (B 2, L 64, C 1024) through K3's plain
    version against JAX's `fused_attention_block` (interpret mode), at the
    tolerance `ops.checks.compare` holds K3 to on the card (mean rel < 1e-3,
    >= 99% within 1 bf16 ulp; f32 sums in other orders)."""
    rng = np.random.default_rng(1024 + int8_core)
    x, *rest = _k3_inputs(rng, 64, 1024)
    got = ia.fused_attention_block(_t(x.astype(np.float32)).to(torch.bfloat16), *_tree(rest, _t),
                                   scale=1024 ** -0.5, int8_core=int8_core)
    want = j_fused_attention_block(jnp.asarray(x), *_tree(rest, jnp.asarray), scale=1024 ** -0.5,
                                   int8_core=int8_core, interpret=True)
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    rel, within = np.abs(got - want).mean() / np.abs(want).mean(), (_bf16_ulps(got, want) <= 1.0).mean()
    assert rel < 1e-3 and within >= 0.99, (rel, within)


@pytest.mark.parametrize("HW,C", [(64, 2048), (64, 1536), (256, 1536)])
def test_k4_past_1024_matches_jax(HW, C):
    """K4's plain version at imagenet64's decoder entries against JAX's
    `gn_act_quant` (interpret mode): at most 1 LSB on at most 0.1% of codes."""
    rng = np.random.default_rng(HW + C)
    x = (rng.standard_normal((2, HW, C)) * 2 + 0.3).astype(ml_dtypes.bfloat16)
    x[..., : C // 32] += 40  # one group at a large offset
    gs, gb = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)
    rmin, rmax = rng.uniform(-1.0, -0.5, C), rng.uniform(2.5, 5.0, C)
    s = (255 / (rmax - rmin)).astype(np.float32)
    z = (np.round(s * rmin) + 128).astype(np.float32)
    (got,) = fg.gn_act_quant(_t(x.astype(np.float32)).to(torch.bfloat16), _t(gs), _t(gb), [(_t(s), _t(z), 8)])
    (want,) = jfg.gn_act_quant(jnp.asarray(x), jnp.asarray(gs), jnp.asarray(gb),
                               [(jnp.asarray(s), jnp.asarray(z), 8)], interpret=True)
    f = checks.compare("K4", (got,), (torch.from_numpy(np.array(want)),))
    assert f["ok"], f


# ---------------------------------------------------------------------------
# the fold's forms and the sampler's options on a toy with the cosine schedule
# ---------------------------------------------------------------------------

TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
SEQ = [0, 300, 600, 900]
FORMS = {"chunked": dict(step_chunk=2, micro_batch=1), "packed": dict(pack_int4=True),
         "chunked_packed": dict(step_chunk=2, micro_batch=1, pack_int4=True), "rank1": dict(rank1=True)}


def _qstates_np(qs):
    return {k: {f: np.asarray(getattr(v, f)) for f in ("init_range", "act_min", "act_max",
                                                       "group_ranges", "alpha_logits")}
            for k, v in qs.items()}


@pytest.fixture(scope="module")
def chain():
    """The JAX chain on the toy with the cosine schedule at bench.py's flags:
    calibration over 4 steps, then its serving sampler plain and with each
    form of FORMS; and the port's inputs."""
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    betas = JSchedule.create("cosine", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(0)
    x_small = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    _, traj, _ = j_ddim_sample(lambda xt, t, i: j_unet_apply(jparams, jcfg, xt, t), jnp.asarray(x_small),
                               SEQ, betas, keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x_small)[None], traj[:-1]], axis=0)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs = j_calibrate_ranges(jq, jparams, jq.init_state(len(SEQ)), xs_in, SEQ, first=True)
    flags = dict(residual_dtype=jnp.bfloat16, attn_int8=False)
    samples = {name: np.asarray(j_sampler(jq, jparams, jqs, SEQ, betas, **flags, **kw)(jnp.asarray(x)))
               for name, kw in {"plain": {}, **FORMS}.items()}
    return dict(jparams=jparams, jqs=jqs, params=from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                                                 device="cpu"),
                qstates=from_jax_qstates(_qstates_np(jqs), device="cpu"), x=x, samples=samples)


def _port():
    cfg = UNetConfig(**TOY)
    return QuantizedUNet.create(cfg, 4, 8), DiffusionSchedule.create("cosine", 1e-4, 0.02, 1000, device="cpu").betas


@pytest.fixture(scope="module")
def plain_sample(chain):
    q, betas = _port()
    return serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, betas, residual_dtype=torch.bfloat16, attn_int8=False)(
        _t(chain["x"]))


@pytest.mark.parametrize("form", ["chunked", "packed", "chunked_packed"])
def test_forms_equal_the_plain_sampler_to_the_bit(chain, plain_sample, form):
    """step_chunk=2 with micro_batch=1, pack_int4, and both: the same bits as
    the plain sampler (a chunk's fold is the same rows of the whole fold;
    packing changes no weight; each image runs alone through the same
    operations)."""
    q, betas = _port()
    out = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, betas, residual_dtype=torch.bfloat16,
                               attn_int8=False, **FORMS[form])(_t(chain["x"]))
    assert torch.equal(out, plain_sample)


@pytest.mark.parametrize("form", ["plain", *FORMS])
def test_forms_match_jax(chain, plain_sample, form):
    """Each form against JAX's sampler with the same flags, to the toy
    sampler's bound of tests/test_torch_serving.py (the port's fold of JAX's
    qstates differs in zcbias's last bits, ROADMAP Queue 3)."""
    q, betas = _port()
    out = plain_sample if form == "plain" else serving_ddim_sampler(
        q, chain["params"], chain["qstates"], SEQ, betas, residual_dtype=torch.bfloat16, attn_int8=False,
        **FORMS[form])(_t(chain["x"]))
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["samples"][form])
    assert rel < 1e-2, rel


def test_rank1_sampler_differs_from_the_per_step_fold(chain, plain_sample):
    """The rank-1 sampler is another quantization: close to the per-step
    fold's sample, not equal to it."""
    q, betas = _port()
    out = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, betas, residual_dtype=torch.bfloat16,
                               attn_int8=False, rank1=True)(_t(chain["x"]))
    rel = _rel(out.numpy(), plain_sample.numpy())
    assert 0 < rel < 0.1, rel


def test_pack_int4_is_jax_transposed():
    """The port packs the K-major fold along K: its bytes are JAX's
    `pack_int4` of the [K, Np] fold, transposed; the round trip is exact."""
    rng = np.random.default_rng(4)
    gq = rng.integers(-8, 8, (3, 2 * 1152, 256)).astype(np.int8)
    got = pack_int4(k_major(_t(gq)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 256, 1152)
    np.testing.assert_array_equal(got.transpose(-1, -2).numpy(), np.asarray(j_pack_int4(jnp.asarray(gq))))
    assert torch.equal(unpack_int4(got), k_major(_t(gq)))
    flat = torch.empty(got.numel() * 2, dtype=torch.int8)
    assert unpack_int4(got.reshape(-1), out=flat) is flat and torch.equal(flat.view(3, 256, 2304), k_major(_t(gq)))


def test_packed_fold_holds_half_the_codes(chain):
    """A packed fold: the same step weights as the unpacked fold through
    `gather_step`, in one buffer of half its codes' bytes (plus one step's
    unpacked codes)."""
    from attentiondm_tpu_torch.quant.int8_serving import gather_step

    q, _ = _port()
    full = prepare_serving_runtime(q, chain["params"], chain["qstates"])
    packed = prepare_serving_runtime(q, chain["params"], chain["qstates"], pack_int4=True)
    codes = sum(lay.gqt.numel() for lay in full.values())
    assert packed.packed.numel() * 2 == codes and packed.unpacked.numel() == codes // len(SEQ)
    assert runtime_nbytes(packed) == runtime_nbytes(full) - codes + codes // 2 + codes // len(SEQ)
    for i in range(len(SEQ)):
        a, b = gather_step(full, i), gather_step(packed, i)
        for name in full:
            assert torch.equal(a[name].gqt, b[name].gqt) and torch.equal(a[name].gq, b[name].gq), (i, name)
    chunk = prepare_serving_runtime(q, chain["params"], chain["qstates"], steps=slice(2, 4))
    for name in full:
        assert torch.equal(chunk[name].gqt, full[name].gqt[2:4]) and torch.equal(chunk[name].zcbias,
                                                                                  full[name].zcbias[2:4])


def test_rank1_matches_jax(chain):
    """`rank1_factors`, `rank1_scale_zp` and `_fold_all_steps(rank1=True)` on
    one calibrated layer against JAX's: gq bit-equal ([1, K, Np], shared),
    the factors, scales and zero points to f32 rounding, zcbias within the
    last-bits bound of the per-step fold (ROADMAP Queue 3)."""
    name = "down.1.block.0.conv1"
    jst, st = chain["jqs"][name], chain["qstates"][name]
    ju, jm = jr1.rank1_factors(jst, 8)
    u, m = tr1.rank1_factors(st, 8)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=2e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-6)
    jscale, jzp = jr1.rank1_scale_zp(jst, 8, ju, jm)
    scale, zp = tr1.rank1_scale_zp(st, 8, _t(np.asarray(ju)), _t(np.asarray(jm)))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(zp.numpy(), np.asarray(jzp))

    kernel = chain["jparams"]["down"][1]["block"][0]["conv1"]["kernel"]
    jgq, jws, _jwzp, jzc, jsc, jz = j_fold_all_steps(kernel, jst.group_ranges, jst.alpha_logits, 8, 4, True,
                                                     rank1=True)
    gq, ws, _wzp, zc, sc, z = _fold_all_steps(_t(np.asarray(kernel)), st.group_ranges, st.alpha_logits, 8, 4,
                                              rank1=True)
    assert tuple(gq.shape) == tuple(jgq.shape) and gq.shape[0] == 1
    np.testing.assert_array_equal(gq.numpy(), np.asarray(jgq))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-6)
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=2e-6)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_allclose(zc.numpy(), np.asarray(jzc), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the options' refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(rank1=True, step_chunk=2), "rank1"),
    (dict(runtime={}, step_chunk=2), "prebuilt runtime"),
    (dict(micro_batch=1), "micro_batch"),
], ids=["rank1_step_chunk", "runtime_step_chunk", "micro_batch_alone"])
def test_sampler_refuses_option_pairs(chain, kw, match):
    """As JAX: rank1 and a prebuilt runtime refuse step_chunk.  Unlike JAX,
    which ignores it, micro_batch without step_chunk raises (ROADMAP Queue 3)."""
    q, betas = _port()
    with pytest.raises(ValueError, match=match):
        serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, betas, residual_dtype=torch.bfloat16, **kw)


def test_rank1_fold_refuses_a_step_slice(chain):
    q, _ = _port()
    with pytest.raises(ValueError, match="rank1"):
        prepare_serving_runtime(q, chain["params"], chain["qstates"], steps=slice(0, 2), rank1=True)
