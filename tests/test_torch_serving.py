"""PyTorch port vs the JAX package: the int8 serving forward, the serving
DDIM sampler and the whole slice (FP teacher -> stage-1 calibration -> fold
-> sample) at bench.py's flags, on a toy UNet at W4A8.

The JAX side runs once per module (calibration, fold, one serving step and
a 2-step sampler), its Pallas kernels in interpret mode."""
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
from attentiondm_tpu.quant.int8_serving import prepare_serving_runtime as j_prepare
from attentiondm_tpu.quant.int8_serving import serving_ddim_sampler as j_sampler
from attentiondm_tpu.quant.int8_serving import serving_model_fn as j_model_fn
from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_apply
from attentiondm_tpu_torch.ops import pallas_conv
from attentiondm_tpu_torch.quant.calibrate import calibrate_ranges
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
SEQ = [0, 500]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _qstates_np(qs):
    return {k: {f: np.asarray(getattr(v, f)) for f in ("init_range", "act_min", "act_max",
                                                       "group_ranges", "alpha_logits")}
            for k, v in qs.items()}


@pytest.fixture(scope="module")
def chain():
    """The JAX chain at bench.py's flags, and the port's inputs."""
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(0)
    x_small = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    _, traj, _ = j_ddim_sample(lambda xt, t, i: j_unet_apply(jparams, jcfg, xt, t), jnp.asarray(x_small),
                               SEQ, betas, keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x_small)[None], traj[:-1]], axis=0)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs = j_calibrate_ranges(jq, jparams, jq.init_state(len(SEQ)), xs_in, SEQ, first=True)
    jrt = j_prepare(jq, jparams, jqs)
    t = np.full((2,), 500.0, np.float32)
    eps = j_model_fn(jq, jrt, jparams, jqs, residual_dtype=jnp.bfloat16, attn_int8=False)(
        jnp.asarray(x), jnp.asarray(t), 0)
    sample = j_sampler(jq, jparams, jqs, SEQ, betas, residual_dtype=jnp.bfloat16, attn_int8=False,
                       runtime=jrt)(jnp.asarray(x))
    runtime = {k: ServingLayer(*(torch.tensor(np.asarray(a)) for a in
                                 (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp)))
               for k, v in jrt.items()}
    return dict(
        params=from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        qstates=from_jax_qstates(_qstates_np(jqs), device="cpu"), runtime=runtime,
        x_small=x_small, x=x, t=t, eps=np.asarray(eps), sample=np.asarray(sample),
        qstates_np=_qstates_np(jqs),
    )


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")


def test_serving_step_matches_jax(chain):
    """One serving_unet_apply with JAX's qstates and fold."""
    cfg, q, _ = _port()
    eps = serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                             torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0, residual_dtype=torch.bfloat16,
                             attn_int8=False)
    assert eps.shape == chain["eps"].shape and torch.isfinite(eps).all()
    rel = _rel(eps.numpy(), chain["eps"])
    # measured 0.0 at this seed.  Not bit-exact by construction: both sum the
    # GroupNorm and attention statistics in f32 but not always in one order,
    # JAX takes rsqrt and sigmoid where the port takes 1/sqrt and 1/(1+exp),
    # and the fake-quant conv_in is an f32 conv in another order, so one
    # value on a rounding tie can flip an int8 code by 1 LSB, and the chain
    # of quantizers carries the flip to the output (about 1.5e-3 here when
    # that happened)
    assert rel < 2e-3, rel


def test_serving_sampler_matches_jax(chain):
    """The 2-step serving sampler with JAX's qstates (the port folds them)."""
    cfg, q, sched = _port()
    sample = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, residual_dtype=torch.bfloat16,
                                  attn_int8=False)
    out = sample(torch.from_numpy(chain["x"]))
    rel = _rel(out.numpy(), chain["sample"])
    assert torch.isfinite(out).all()
    # measured 7.0e-3: the port's own fold differs from JAX's in zcbias's
    # last bits (f32 dot in another order), which flips a few codes per step
    assert rel < 1e-2, rel


def test_whole_slice_matches_jax(chain):
    """Port teacher -> port calibration -> port fold -> port sampler, against
    the JAX chain from the same numpy inputs."""
    cfg, q, sched = _port()
    params = chain["params"]
    x_small = torch.from_numpy(chain["x_small"])
    _, traj, _ = ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x_small, SEQ, sched.betas,
                             keep_trajectory=True)
    xs_in = torch.cat([x_small[None], traj[:-1]])
    qstates = calibrate_ranges(q, params, q.init_state(len(SEQ), "cpu"), xs_in, SEQ)
    out = serving_ddim_sampler(q, params, qstates, SEQ, sched.betas, residual_dtype=torch.bfloat16, attn_int8=False)(
        torch.from_numpy(chain["x"]))
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["sample"])
    assert rel < 2e-2, rel  # measured 9.2e-3: the port's own teacher, calibration and fold


def test_cpu_path_takes_plain_versions(chain):
    """On CPU tensors the wrappers run their plain versions: no launches."""
    cfg, q, _ = _port()
    before = pallas_conv.int8_conv.launches
    a = serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                           torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 1, residual_dtype=torch.bfloat16, attn_int8=False)
    b = serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                           torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 1, residual_dtype=torch.bfloat16, attn_int8=False,
                           plain=True)
    assert pallas_conv.int8_conv.launches == before
    assert torch.equal(a, b)


def test_fold_of_jax_qstates_matches_jax_runtime(chain):
    """The port's fold of the calibrated JAX qstates equals JAX's fold."""
    cfg, q, _ = _port()
    rt = prepare_serving_runtime(q, chain["params"], chain["qstates"])
    assert rt.keys() == chain["runtime"].keys()
    for name, lay in rt.items():
        ref = chain["runtime"][name]
        assert torch.equal(lay.gq, ref.gq), name
        for f in ("inv_ws", "act_scale", "act_zp"):
            np.testing.assert_allclose(getattr(lay, f).numpy(), getattr(ref, f).numpy(), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(lay.zcbias.numpy(), ref.zcbias.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


# values JAX does not define or refuses: a resblock_pallas other than False / True / "all" (JAX treats any
# truthy value as True; JAX has a shape-list form for conv_pallas only), a malformed conv_pallas, a residual
# stream other than f32 / bf16, asymmetric serving folds (JAX refuses them, pointing to the interception
# runtime), an update other than "ddim" / "ddpm" (JAX raises ValueError too)
FLAGS = {
    "resblock_pallas": ("resblock_pallas", ((8, 128, 128),)), "conv_pallas_str": ("conv_pallas", "some"),
    "conv_pallas_pair": ("conv_pallas", [(8, 128)]), "residual_dtype_float16": ("residual_dtype", torch.float16),
}
SAMPLER_FLAGS = {**FLAGS, "symmetric": ("symmetric", False), "update": ("update", "ancestral")}


@pytest.mark.parametrize("flag,value", SAMPLER_FLAGS.values(), ids=list(SAMPLER_FLAGS))
def test_unported_serving_flags_raise(chain, flag, value):
    """Every flag value off the serving path raises ValueError instead of
    being ignored (the ddpm update and eta != 0 are taken:
    tests/test_torch_ddpm.py)."""
    cfg, q, sched = _port()
    with pytest.raises(ValueError):
        if (flag, value) in FLAGS.values():
            serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                               torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0, **{flag: value})
        else:
            serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, **{flag: value})


@pytest.mark.parametrize("flag", ["attn_int8", "attn_ranges"])
def test_attention_flags_are_taken(chain, flag):
    """`attn_int8=True` is the default, as in JAX, and on this toy (L = 64, C =
    256: the whole-block kernel takes the map) runs K3's int8 core, a small
    step away from the float32 core; `attn_ranges` are taken and, as in JAX,
    not read where the block fits."""
    cfg, q, _ = _port()

    def step(**kw):
        return serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                                  torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]), 0, residual_dtype=torch.bfloat16, **kw)

    default = step()
    assert torch.equal(default, step(attn_int8=True))
    if flag == "attn_int8":
        rel = _rel(default.numpy(), step(attn_int8=False).numpy())
        # measured 3.4e-2 on this toy's random weights; tests/test_torch_attn_int8.py holds the int8 cores to JAX's
        assert 0 < rel < 0.1, rel
    else:
        ranges = {f"mid.attn_1.{k}": torch.ones(len(SEQ)) for k in ("q", "k", "v")}
        assert torch.equal(default, step(attn_ranges=ranges)) and torch.equal(default, step(attn_ranges={}))


# the deepest level holds 1152 channels at 4x4: no K2 / K6 plan takes the resblock epilogue there
WIDE = dict(ch=128, ch_mult=(1, 9), num_res_blocks=1, attn_resolutions=(), resolution=8, dropout=0.0)
# the decoder's first block concatenates 768 + 768 channels at 4x4: K4 takes C = 1536 (up to 2048)
WIDE_ENTRY = dict(ch=128, ch_mult=(1, 6), num_res_blocks=1, attn_resolutions=(), resolution=8, dropout=0.0)


def test_sampler_names_refused_gn_sites_before_step_0(monkeypatch):
    """`serving_ddim_sampler`'s sample checks the GroupNorm and resblock sites
    of its levers against the kernels' plans before it runs a step: with the
    check held to a CUDA device, a config whose deepest level exceeds 1024
    channels stops before the first UNet call, naming the site, and one whose
    widest concat is 1536 channels runs with `entry_pallas` (K4 takes it)."""
    from attentiondm_tpu_torch.models.unet import unet_init
    from attentiondm_tpu_torch.ops import checks
    from attentiondm_tpu_torch.quant import int8_serving as srv

    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas
    check = checks.require_gn_kernels
    monkeypatch.setattr(srv, "require_gn_kernels", lambda cfg, device, batch, **kw: check(cfg, "cuda", batch, **kw))
    step = srv.serving_unet_apply
    steps = []
    monkeypatch.setattr(srv, "serving_unet_apply", lambda *a, **kw: steps.append(1) or step(*a, **kw))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 3, generator=gen)
    q = QuantizedUNet.create(UNetConfig(**WIDE), 4, 8)
    for levers in ({}, dict(entry_pallas=True)):
        with pytest.raises(NotImplementedError, match=r"mid\.block_1 \(HW=16, C=1152\) -> K2/K6"):
            # a prebuilt (empty) fold: nothing of the model is read before the check
            srv.serving_ddim_sampler(q, None, None, [0], betas, runtime={}, residual_dtype=torch.bfloat16, **levers)(x)
    assert not steps
    cfg = UNetConfig(**WIDE_ENTRY)
    params = unet_init(gen, cfg, "cpu")
    q = QuantizedUNet.create(cfg, 4, 8)
    qstates = q.init_state(1, "cpu")
    assert srv.serving_ddim_sampler(q, params, qstates, [0], betas, residual_dtype=torch.bfloat16, entry_pallas=True)(x).shape == x.shape
    assert steps
