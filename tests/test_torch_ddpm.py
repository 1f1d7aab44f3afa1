"""PyTorch port vs the JAX package: the stochastic samplers.  `ddpm_step`,
`ddpm_sample` and `ddim_sample` at eta 0.5 on the toy FP UNet, and the
serving sampler with `update="ddpm"` and with eta 0.5 (unchunked, and with
`step_chunk=1` and two micro-batches).

torch cannot reproduce JAX's threefry draws, so every test hands JAX's own
per-step normals to the port through the samplers' `noise=` keyword: the
split chain of the sampler's key (`k, sub = split(k)` a step), and under
micro-batches one chain per micro-batch from `fold_in(key, i)`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion import ddim_sample as j_ddim_sample
from attentiondm_tpu.diffusion import ddpm_sample as j_ddpm_sample
from attentiondm_tpu.diffusion.sampling import ddpm_step as j_ddpm_step
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import calibrate_ranges as j_calibrate_ranges
from attentiondm_tpu.quant.int8_serving import prepare_serving_runtime as j_prepare
from attentiondm_tpu.quant.int8_serving import serving_ddim_sampler as j_sampler
from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, ddpm_sample, ddpm_step
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_apply
from attentiondm_tpu_torch.quant.int8_serving import ServingLayer, serving_ddim_sampler, serving_model_fn
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
from attentiondm_tpu_torch.quant.state import from_jax_qstates


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
SEQ = [0, 500]
N = 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def split_chain(key, shape, steps):
    """The per-step normals a JAX sampler draws from `key`: [steps, *shape]."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return np.stack(out)


def micro_chains(key, shape, steps, n_mb):
    """JAX's chunked sampler's normals under `n_mb` micro-batches: one chain a
    micro-batch from `fold_in(key, i)`, joined along the batch."""
    mb = (shape[0] // n_mb,) + tuple(shape[1:])
    return np.concatenate([split_chain(jax.random.fold_in(key, i), mb, steps) for i in range(n_mb)], axis=1)


def _qstates_np(qs):
    return {k: {f: np.asarray(getattr(v, f)) for f in ("init_range", "act_min", "act_max", "group_ranges",
                                                       "alpha_logits")} for k, v in qs.items()}


@pytest.fixture(scope="module")
def chain():
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(0), jcfg)
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    shape = x.shape

    def fp(xt, t, i):
        return j_unet_apply(jparams, jcfg, xt, t)

    out = dict(x=x, noise=split_chain(key, shape, len(SEQ)), noise_mb=micro_chains(key, shape, len(SEQ), 2))
    out["fp_ddpm"] = np.asarray(j_ddpm_sample(fp, jnp.asarray(x), SEQ, betas, key=key))
    out["fp_eta"] = np.asarray(j_ddim_sample(fp, jnp.asarray(x), SEQ, betas, eta=0.5, key=key))

    _, traj, _ = j_ddim_sample(fp, jnp.asarray(x), SEQ, betas, keep_trajectory=True)
    xs_in = jnp.concatenate([jnp.asarray(x)[None], traj[:-1]], axis=0)
    jq = JQuantizedUNet.create(jcfg, bitwidth=4, a_bitwidth=8)
    jqs = j_calibrate_ranges(jq, jparams, jq.init_state(len(SEQ)), xs_in, SEQ, first=True)
    jrt = j_prepare(jq, jparams, jqs)
    flags = dict(attn_int8=False)
    out["srv_ddpm"] = np.asarray(j_sampler(jq, jparams, jqs, SEQ, betas, update="ddpm", runtime=jrt, **flags)(
        jnp.asarray(x), key))
    out["srv_eta"] = np.asarray(j_sampler(jq, jparams, jqs, SEQ, betas, eta=0.5, runtime=jrt, **flags)(
        jnp.asarray(x), key))
    out["srv_ddpm_mb"] = np.asarray(j_sampler(jq, jparams, jqs, SEQ, betas, update="ddpm", step_chunk=1,
                                              micro_batch=N // 2, **flags)(jnp.asarray(x), key))
    out["runtime"] = {k: ServingLayer(*(torch.tensor(np.asarray(a)) for a in
                                        (v.gq, v.inv_ws, v.zcbias, v.act_scale, v.act_zp)))
                      for k, v in jrt.items()}
    out["params"] = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    out["qstates"] = from_jax_qstates(_qstates_np(jqs), device="cpu")
    return out


def _port():
    cfg = UNetConfig(**TOY)
    return cfg, QuantizedUNet.create(cfg, 4, 8), DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")


@pytest.mark.parametrize("t", [0, 500])
def test_ddpm_step_matches_jax(t):
    """One ancestral update on the same inputs: the x0 clip, the posterior
    mean and (t > 0 only) the noise term; float32 algebra, measured at most
    a few ulps apart (JAX's XLA fuses the elementwise chain)."""
    rng = np.random.default_rng(t)
    xt, et, noise = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) * 3 for _ in range(3))
    at, atm1 = np.float32(0.3), np.float32(0.35)
    want = j_ddpm_step(jnp.asarray(xt), jnp.asarray(et), at, atm1, jnp.float32(t), jnp.asarray(noise))
    got = ddpm_step(*(torch.from_numpy(a) for a in (xt, et)), torch.tensor(at), torch.tensor(atm1),
                    torch.tensor(float(t)), torch.from_numpy(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    if t == 0:  # the last step adds no noise
        np.testing.assert_array_equal(got[0].numpy(), ddpm_step(*(torch.from_numpy(a) for a in (xt, et)),
                                                                torch.tensor(at), torch.tensor(atm1), torch.tensor(0.0),
                                                                torch.zeros(2, 4, 4, 3))[0].numpy())


@pytest.mark.parametrize("which", ["fp_ddpm", "fp_eta"])
def test_fp_stochastic_samplers_match_jax(chain, which):
    """`ddpm_sample` and `ddim_sample(eta=0.5)` on the FP toy UNet with JAX's
    split-chain normals: measured 4.6e-7 (ddpm) and 7.0e-7 (eta 0.5) mean
    relative (float32 convs summed in another order); held to 2.5e-6."""
    cfg, _, sched = _port()

    def model(xt, t, i):
        return unet_apply(chain["params"], cfg, xt, t)

    x, noise = torch.from_numpy(chain["x"]), torch.from_numpy(chain["noise"])
    if which == "fp_ddpm":
        out = ddpm_sample(model, x, SEQ, sched.betas, noise=noise)
    else:
        out = ddim_sample(model, x, SEQ, sched.betas, eta=0.5, noise=noise)
    rel = _rel(out.numpy(), chain[which])
    assert rel < 2.5e-6, rel


def test_stochastic_samplers_need_a_source_of_noise(chain):
    """A stochastic sampler draws only from what it is given: without a
    generator or the draws it raises; with a generator it is repeatable."""
    cfg, _, sched = _port()

    def model(xt, t, i):
        return unet_apply(chain["params"], cfg, xt, t)

    x = torch.from_numpy(chain["x"])
    with pytest.raises(ValueError, match="generator"):
        ddpm_sample(model, x, SEQ, sched.betas)
    a = ddim_sample(model, x, SEQ, sched.betas, eta=0.5, generator=torch.Generator().manual_seed(3))
    b = ddim_sample(model, x, SEQ, sched.betas, eta=0.5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert not torch.equal(a, ddim_sample(model, x, SEQ, sched.betas))


@pytest.mark.parametrize("which", ["srv_ddpm", "srv_eta"])
def test_serving_stochastic_samplers_match_jax(chain, which):
    """The serving sampler with `update="ddpm"` and with eta 0.5 on JAX's
    fold, with JAX's normals; held to test_torch_serving.py's sampler bound,
    1e-2 (measured 3.3e-3 ddpm, 4.3e-3 eta 0.5: a few int8 codes on rounding
    ties flip, test_torch_serving.py's step test says why)."""
    cfg, q, sched = _port()
    kw = dict(update="ddpm") if which == "srv_ddpm" else dict(eta=0.5)
    sample = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, attn_int8=False,
                                  runtime=chain["runtime"], **kw)
    out = sample(torch.from_numpy(chain["x"]), noise=torch.from_numpy(chain["noise"]))
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain[which])
    assert rel < 1e-2, rel


def test_serving_ddpm_micro_batches_match_jax(chain):
    """`step_chunk=1, micro_batch=N/2` with update="ddpm": each micro-batch
    takes its own stream (JAX's `fold_in(key, i)` chains handed in, sliced
    along the batch), the port folding the chunks itself; held to the
    sampler bound of test_torch_serving.py, 1e-2."""
    cfg, q, sched = _port()
    sample = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, attn_int8=False,
                                  update="ddpm", step_chunk=1, micro_batch=N // 2)
    out = sample(torch.from_numpy(chain["x"]), noise=torch.from_numpy(chain["noise_mb"]))
    rel = _rel(out.numpy(), chain["srv_ddpm_mb"])
    assert rel < 1e-2, rel


def test_serving_micro_batch_streams(chain):
    """With a generator, the chunked + micro-batched sampler gives each
    micro-batch its own stream (seeded from the caller's generator), is
    repeatable, and at eta = 0 stays bit-equal to the unchunked sampler."""
    cfg, q, sched = _port()
    x = torch.from_numpy(chain["x"])
    x2 = torch.cat([x[:1], x[:1]])  # the same image in both micro-batches
    chunked = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, attn_int8=False,
                                   eta=0.5, step_chunk=1, micro_batch=1)
    a = chunked(x2, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, chunked(x2, generator=torch.Generator().manual_seed(5)))
    assert not torch.equal(a[0], a[1])  # independent streams
    det = dict(attn_int8=False)
    plain = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, **det)(x)
    mb = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, step_chunk=1, micro_batch=1,
                              **det)(x)
    assert torch.equal(plain, mb)


@pytest.mark.parametrize("which", ["srv_ddpm", "srv_eta"])
def test_serving_model_fn_in_the_generic_samplers(chain, which):
    """`serving_model_fn` (the serving forward as a `(x, t, step_idx) -> eps`
    closure) through `ddpm_sample` / `ddim_sample` gives the serving
    sampler's output to the bit on the same fold and draws."""
    cfg, q, sched = _port()
    x, noise = torch.from_numpy(chain["x"]), torch.from_numpy(chain["noise"])
    fn = serving_model_fn(q, chain["runtime"], chain["params"], chain["qstates"], attn_int8=False)
    kw = dict(update="ddpm") if which == "srv_ddpm" else dict(eta=0.5)
    want = serving_ddim_sampler(q, chain["params"], chain["qstates"], SEQ, sched.betas, attn_int8=False,
                                runtime=chain["runtime"], **kw)(x, noise=noise)
    if which == "srv_ddpm":
        got = ddpm_sample(fn, x, SEQ, sched.betas, noise=noise)
    else:
        got = ddim_sample(fn, x, SEQ, sched.betas, eta=0.5, noise=noise)
    assert torch.equal(got, want)
