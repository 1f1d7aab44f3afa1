"""PyTorch port vs the JAX package on the LSUN church path: config loading,
and the serving slice (FP teacher -> JAX's stage-1 calibration -> fold ->
one serving step -> 2-step sampler) on a toy church-shaped UNet at W4A8.

The toy keeps the church features that matter for the kernels: 128
channels at 112^2, so K2's whole-image budget is exceeded and both JAX and
the port take the blocked epilogue K6 at level 0, and attention at 14^2 with
C = 512 (K3 at C = 512), and Cp = 1024 at the deepest up-path concats.
112^2 instead of 128^2 keeps the JAX side (XLA's int8 convs and Pallas in
interpret mode, on the CPU) near one minute.  The JAX chain runs once per
module.  The port's own stage-1 calibration is shape-agnostic and takes 81 s
on one CPU thread at 112^2, so the whole slice from the port's calibration
is held against JAX on the CIFAR toy only (tests/test_torch_serving.py).

At this depth and size one int8 code that the two sides round differently
(f32 sums in another order, rsqrt vs 1/sqrt: a few per million codes) is
certain, and the chain of quantizers spreads it to the quantization-noise
level of the output.  So the step is held to a gross bound, and each kernel
site to its own tolerance with JAX's inputs (teacher-forced)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from attentiondm_tpu.config import load_config as j_load_config
from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion.sampling import _seq_alphas as j_seq_alphas
from attentiondm_tpu.diffusion.sampling import ddim_step as j_ddim_step
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.ops import int8_attention as j_int8_attention
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import calibrate_ranges as j_calibrate_ranges
from attentiondm_tpu.quant import int8_serving as j_serving
from attentiondm_tpu_torch.config import load_config, namespace2dict
from attentiondm_tpu_torch.diffusion.sampling import ddim_sample
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_apply
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.ops.fused_gn import epilogue_gn_swish_quant
from attentiondm_tpu_torch.ops.int8_attention import fused_attention_block
from attentiondm_tpu_torch.quant.int8_serving import (
    ServingLayer,
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


TOY = dict(ch=128, ch_mult=(1, 1, 1, 4), num_res_blocks=1, attn_resolutions=(14,), resolution=112, dropout=0.0)
SEQ = [0, 500]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


# ---------------------------------------------------------------------------
# config loading
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["church.yml", "cifar10.yml", "bedroom.yml"])
def test_from_config_matches_jax(name):
    """`UNetConfig.from_config` and `DiffusionSchedule.from_config` of a
    shipped config give JAX's fields (schedules: float32 tensors equal); the
    fields JAX's config lacks (the port's ADM ones) keep their DDPM defaults."""
    cfg, jcfg = load_config(name), j_load_config(name)
    assert namespace2dict(cfg) == namespace2dict(jcfg)
    jc = JConfig.from_config(jcfg)
    assert UNetConfig.from_config(cfg) == UNetConfig(**{
        f: getattr(jc, f) for f in UNetConfig.__dataclass_fields__ if hasattr(jc, f)})
    assert UNetConfig.from_config(cfg).model_type == "ddpm" and UNetConfig.from_config(cfg).gn_eps == 1e-6
    sched, jsched = DiffusionSchedule.from_config(cfg, device="cpu"), JSchedule.from_config(jcfg)
    for f in ("betas", "alphas_cumprod", "logvar"):
        np.testing.assert_array_equal(getattr(sched, f).numpy(), np.asarray(getattr(jsched, f)), err_msg=f)


def test_church_config_is_the_served_one():
    """church.yml: 256^2, ch 128, ch_mult 1-1-2-2-4-4, 2 res blocks,
    attention at 16^2, dropout 0, the linear 1e-4..0.02 schedule."""
    cfg = UNetConfig.from_config(load_config("church.yml"))
    assert cfg == UNetConfig(resolution=256, ch_mult=(1, 1, 2, 2, 4, 4), attn_resolutions=(16,), dropout=0.0)
    plan = checks.expected_launches(cfg, attn_int8=False)
    assert (plan["K6"], plan["K2"], plan["K3"]) == (10, 22, 6)


def test_unported_var_type_raises():
    """A variance neither package has ("learned") raises; fixedlarge and
    fixedsmall are ported (tests/test_torch_imagenet64.py)."""
    cfg = load_config("church.yml")
    cfg.model.var_type = "learned"
    with pytest.raises(NotImplementedError, match="var_type='learned'"):
        DiffusionSchedule.from_config(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the serving slice on the toy
# ---------------------------------------------------------------------------


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(a) for a in tree)
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


def _torch(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch(a) for a in tree)
    if isinstance(tree, np.ndarray):
        if tree.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(tree.astype(np.float32)).to(torch.bfloat16)  # exact
        return torch.from_numpy(np.array(tree))
    return tree


@pytest.fixture(scope="module")
def chain():
    """The JAX chain at bench.py's flags on the toy: stage-1 calibration on
    the port's FP teacher trajectory (unet_apply is held against JAX's in
    tests/test_torch_unet.py), the fold, and the 2-step serving sampler,
    its first step recording every K2/K6 and K3 call (inputs and output)."""
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    cfg = UNetConfig(**TOY)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(0)
    x_small = torch.from_numpy(rng.standard_normal((1, 112, 112, 3)).astype(np.float32))
    x = rng.standard_normal((1, 112, 112, 3)).astype(np.float32)
    _, traj, _ = ddim_sample(lambda xt, t, i: unet_apply(params, cfg, xt, t), x_small, SEQ,
                             DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas, keep_trajectory=True)
    xs_in = jnp.asarray(torch.cat([x_small[None], traj[:-1]]).numpy())
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs = j_calibrate_ranges(jq, jparams, jq.init_state(len(SEQ)), xs_in, SEQ, first=True)
    jrt = j_serving.prepare_serving_runtime(jq, jparams, jqs)
    # JAX's serving sampler is a scan of this model_fn and ddim_step; its
    # first step is the serving step compared below
    model_fn = j_serving.serving_model_fn(jq, jrt, jparams, jqs, residual_dtype=jnp.bfloat16, attn_int8=False)
    t_rev, _, at, at_next = j_seq_alphas(betas, SEQ)
    sites, saved = [], (j_serving.epilogue_gn_swish_quant, j_int8_attention.fused_attention_block)

    def record(kind, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            sites.append((kind, _np(args), kwargs, np.asarray(out)))
            return out
        return call

    j_serving.epilogue_gn_swish_quant = record("epilogue", saved[0])
    j_int8_attention.fused_attention_block = record("K3", saved[1])
    try:
        eps0 = model_fn(jnp.asarray(x), jnp.full((1,), t_rev[0], jnp.float32), 0)
    finally:
        j_serving.epilogue_gn_swish_quant, j_int8_attention.fused_attention_block = saved
    xt, _ = j_ddim_step(jnp.asarray(x), eps0, at[0], at_next[0], 0.0, jnp.zeros_like(eps0))
    et = model_fn(xt, jnp.full((1,), t_rev[1], jnp.float32), 1)
    xt, _ = j_ddim_step(xt, et, at[1], at_next[1], 0.0, jnp.zeros_like(xt))
    qs_np = {k: {f: np.asarray(getattr(v, f)) for f in ("init_range", "act_min", "act_max", "group_ranges",
                                                        "alpha_logits")} for k, v in jqs.items()}
    return dict(
        params=params, qstates=from_jax_qstates(qs_np, device="cpu"),
        runtime={k: ServingLayer(*(torch.tensor(np.asarray(a)) for a in
                                   (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp))) for k, v in jrt.items()},
        x=x, eps=np.asarray(eps0), sample=np.asarray(xt), sites=sites,
    )


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")


def test_kernel_sites_follow_the_plan(chain):
    """One serving step calls K1, K2, K6 and K3 at the sites `conv_plan`
    derives from the config (K6 at the 112^2 level, K3 at C = 512), as JAX
    does, and K4 at every GroupNorm entry `lever_plan` names (JAX's XLA
    entry at levers off); on the CPU every site runs the plain versions, so
    each agrees exactly."""
    cfg, q, _ = _port()
    records = []
    with checks.per_site(records):
        serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                           torch.from_numpy(chain["x"]), torch.full((1,), 500.0), 0, residual_dtype=torch.bfloat16, attn_int8=False)
    k1, k2, k6, k3, composed = checks.conv_plan(cfg)
    assert not composed
    kinds = [r[0] for r in records]
    assert [kinds.count(k) for k in ("K1", "K2", "K6", "K3")] == [len(k1), len(k2), len(k6), len(k3)]
    assert (len(k6), len(k3)) == (3, 4) and {c for _, c in k3} == {512}
    assert [k for k in kinds if k not in ("K1", "K4")] == [
        k if k == "K3" else checks.fused_gn.epilogue_route(a[0].shape, torch.bfloat16)
        for k, a, _kw, _out in chain["sites"]]
    entries = 1 + sum(1 for name, *_ in k1 if name.endswith(".conv1"))
    assert kinds.count("K4") == len(checks.lever_plan(cfg, 1)["K4"]) == entries
    assert all(r[2]["ok"] and r[2]["max_abs_err"] == 0 for r in records)


def test_kernel_sites_match_jax_teacher_forced(chain):
    """Every K2, K6 and K3 call of JAX's serving step, replayed through the
    port on JAX's own inputs, meets the kernel's tolerance against JAX's
    output (measured: one K2 site with 1.0e-5 of its codes one apart, the
    other 13 K2/K6 sites equal; the K3 sites at most 2.3e-6 mean rel error,
    at least 99.988% within 1 bf16 ulp)."""
    for kind, args, kwargs, want in chain["sites"]:
        targs = _torch(args)
        if kind == "K3":
            got = fused_attention_block(*targs, scale=kwargs["scale"])
        else:
            got = epilogue_gn_swish_quant(*targs)
            kind = checks.fused_gn.epilogue_route(got.shape, torch.bfloat16)
        fig = checks.compare(kind, got, _torch(want))
        assert fig["ok"], (kind, tuple(got.shape), fig)


def test_serving_step_matches_jax(chain):
    """One serving step with JAX's qstates and fold.  Measured 2.6e-2: a
    few codes flip at the first K6 site and spread (module docstring); the
    bound is the gross-fault bound of the chip smoke's chained check."""
    cfg, q, _ = _port()
    eps = serving_unet_apply(chain["params"], cfg, q, chain["runtime"], chain["qstates"],
                             torch.from_numpy(chain["x"]), torch.full((1,), 500.0), 0, residual_dtype=torch.bfloat16, attn_int8=False)
    assert eps.shape == chain["eps"].shape and torch.isfinite(eps).all()
    rel = _rel(eps.numpy(), chain["eps"])
    assert rel < 0.1, rel


def test_serving_sampler_matches_jax(chain):
    """The 2-step serving sampler with JAX's qstates (the port folds them).
    Measured 8.5e-3; bound about 4x."""
    cfg, q, sched = _port()
    out = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, residual_dtype=torch.bfloat16,
                               attn_int8=False)(torch.from_numpy(chain["x"]))
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["sample"])
    assert rel < 3.5e-2, rel
