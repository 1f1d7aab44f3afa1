"""PyTorch port vs the JAX package: the training step
(`attentiondm_tpu_torch.training`, `diffusion/losses.py`, `models/ema.py`,
`unet_apply(train=True)`), on the CPU at a toy width.

JAX draws a step's t, eps and dropout masks from `split(key, 3)`; these
tests derive the same draws from JAX's keys (`jax_step_draws`) and hand
them to the port (`t=`, `e=`, `dropout_masks=`), so both sides take the same
step.  Tolerances, each stated where it is held:
- the loss and the forward: 1e-5 relative (float32 sums in other orders);
- the gradients, leaf by leaf: 1e-4 of the leaf's largest magnitude, or
  1e-8 of the tree's where the leaf's gradient is 0 but for rounding (the
  attention's key bias: a softmax does not see a shift of its logits);
- three steps of each optimizer (`training.compare_train_states`, which
  chip_smoke.py holds the card's step to as well): Adam's first update is
  about lr * sign(g), so an element whose gradient lies within rounding of 0
  may step the other way: the params and EMA are held to 1e-6 of their
  scale on at least 99.9% of elements and to 2 * lr * steps everywhere, each
  moment or trace to 1e-5 of its own scale on 99.9%, the counts exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attentiondm_tpu.config import dict2namespace
from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion.losses import noise_estimation_loss as j_loss
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.training import antithetic_timesteps as j_antithetic
from attentiondm_tpu.training import get_optimizer as j_get_optimizer
from attentiondm_tpu.training import init_train_state as j_init_train_state
from attentiondm_tpu.training import make_train_step as j_make_train_step
from attentiondm_tpu_torch.diffusion.losses import noise_estimation_loss
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, dropout_shapes, from_jax_params, tree_leaves, unet_apply
from attentiondm_tpu_torch.training import (
    antithetic_timesteps,
    compare_train_states,
    get_optimizer,
    global_norm,
    init_train_state,
    loss_and_grads,
    make_train_step,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ch 64 so that every GroupNorm group holds 2 channels or more: at 1 a group removes its channel's bias, whose
# gradient is then 0 up to rounding and Adam's step on it a coin flip
TOY = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.1)
N = 4  # images a batch
T = 1000
LR = 2e-4
STEPS = 3


def jax_dropout_masks(kd, cfg, n: int):
    """The masks JAX's unet_apply(train=True, rng=kd) draws: resblock i's from split(kd, 64)[i]."""
    rngs = jax.random.split(kd, 64)
    keep = 1.0 - cfg.dropout
    return [torch.from_numpy(np.asarray(jax.random.bernoulli(rngs[i], keep, s)))
            for i, s in enumerate(dropout_shapes(cfg, n))]


def jax_step_draws(key, cfg, x_shape, num_timesteps):
    """JAX's train_step draws from `key` as the port's keywords: t, e and the dropout masks."""
    kt, ke, kd = jax.random.split(key, 3)
    t = j_antithetic(kt, x_shape[0], num_timesteps)
    e = jax.random.normal(ke, x_shape, jnp.float32)
    return {"t": torch.from_numpy(np.array(t)).to(torch.int64), "e": torch.from_numpy(np.array(e)),
            "dropout_masks": jax_dropout_masks(kd, cfg, x_shape[0])}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _optim(name, lr=LR, **over):
    o = dict(optimizer=name, lr=lr, beta1=0.9, eps=1e-8, weight_decay=0.0, amsgrad=False, grad_clip=1.0)
    o.update(over)
    return dict2namespace({"optim": o})


@pytest.fixture(scope="module")
def toy():
    jcfg = JConfig(**TOY)
    jparams = j_unet_init(jax.random.PRNGKey(5), jcfg)
    x0 = np.random.default_rng(0).uniform(-1, 1, (N, 8, 8, 3)).astype(np.float32)
    return jcfg, jparams, from_jax_params(_np(jparams), device="cpu"), x0


@pytest.fixture(scope="module")
def betas():
    return np.asarray(JSchedule.create("linear", 1e-4, 0.02, T).betas), \
        DiffusionSchedule.create("linear", 1e-4, 0.02, T, device="cpu").betas


def leaf_pairs(got, want, path=""):
    """(path, port leaf as numpy, JAX leaf as numpy) over two trees of one structure (dicts, lists, tuples)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            yield from leaf_pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from leaf_pairs(g, w, f"{path}/{i}")
    else:
        yield path, (got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)), np.asarray(want)


@pytest.mark.parametrize("keepdim", [False, True])
def test_loss_matches_jax(toy, betas, keepdim):
    """The eps-MSE (and its per-image sums) of the float model: 1e-5 relative."""
    jcfg, jparams, tparams, x0 = toy
    t = np.array([0, 17, 500, 999])
    e = np.random.default_rng(1).standard_normal(x0.shape).astype(np.float32)
    want, wout = j_loss(lambda x, tt: j_unet_apply(jparams, jcfg, x, tt), jnp.asarray(x0), jnp.asarray(t),
                        jnp.asarray(e), jnp.asarray(betas[0]), keepdim=keepdim)
    got, out = noise_estimation_loss(lambda x, tt: unet_apply(tparams, UNetConfig(**TOY), x, tt), torch.from_numpy(x0),
                                     torch.from_numpy(t), torch.from_numpy(e), betas[1], keepdim=keepdim)
    assert got.shape == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(wout), rtol=1e-5, atol=1e-5)


def test_antithetic_timesteps_given_the_base_draws():
    """t = cat([t0, T - t0 - 1])[:n] from the same n // 2 + 1 base draws, for odd and even n."""
    for n in (4, 5, 8):
        key = jax.random.PRNGKey(n)
        base = np.asarray(jax.random.randint(key, (n // 2 + 1,), 0, T))
        got = antithetic_timesteps(None, n, T, base=torch.from_numpy(base.copy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_antithetic(key, n, T)))
    drawn = antithetic_timesteps(torch.Generator().manual_seed(0), 7, T)
    assert drawn.shape == (7,) and (drawn[:3] + drawn[4:7] == T - 1).all() and 0 <= int(drawn.min())


def test_train_forward_with_jax_masks(toy):
    """unet_apply(train=True) with the masks JAX draws from rng equals JAX's
    train forward (1e-5); without randomness, or with train=False, no
    dropout runs; a generator draws masks at the rate keep."""
    jcfg, jparams, tparams, x0 = toy
    cfg = UNetConfig(**TOY)
    kd = jax.random.PRNGKey(9)
    t = np.array([3.0, 250.0, 600.0, 999.0], np.float32)
    want = np.asarray(j_unet_apply(jparams, jcfg, jnp.asarray(x0), jnp.asarray(t), train=True, rng=kd))
    masks = jax_dropout_masks(kd, cfg, N)
    x, tt = torch.from_numpy(x0), torch.from_numpy(t)
    got = unet_apply(tparams, cfg, x, tt, train=True, dropout_masks=masks)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = unet_apply(tparams, cfg, x, tt)
    assert torch.equal(unet_apply(tparams, cfg, x, tt, train=True), plain)
    assert torch.equal(unet_apply(tparams, cfg, x, tt, dropout_masks=masks), plain)
    assert not torch.allclose(got, plain, atol=1e-3)
    g = torch.Generator().manual_seed(0)
    drawn = [torch.rand(s, generator=g) < 0.9 for s in dropout_shapes(cfg, N)]
    rate = float(torch.cat([m.flatten() for m in drawn]).float().mean())
    assert abs(rate - 0.9) < 0.01
    # the generator's draws, resblock by resblock in call order, are the masks
    assert torch.equal(unet_apply(tparams, cfg, x, tt, train=True, generator=torch.Generator().manual_seed(0)),
                       unet_apply(tparams, cfg, x, tt, train=True, dropout_masks=drawn))


def test_grads_match_jax_grad(toy, betas):
    """The gradient tree of the train-mode loss against jax.grad, leaf by
    leaf, within 1e-4 of each leaf's largest magnitude or 1e-8 of the
    tree's; the loss and the global norm 1e-5."""
    jcfg, jparams, tparams, x0 = toy
    cfg = UNetConfig(**TOY)
    draws = jax_step_draws(jax.random.PRNGKey(3), cfg, x0.shape, T)
    kt, ke, kd = jax.random.split(jax.random.PRNGKey(3), 3)

    def jloss(p):
        return j_loss(lambda x, tt: j_unet_apply(p, jcfg, x, tt, train=True, rng=kd), jnp.asarray(x0),
                      jnp.asarray(draws["t"].numpy()), jnp.asarray(draws["e"].numpy()), jnp.asarray(betas[0]))[0]

    wloss, wgrads = jax.value_and_grad(jloss)(jparams)
    loss, grads = loss_and_grads(lambda p, x, tt, **rnd: unet_apply(p, cfg, x, tt, train=True, **rnd), tparams,
                                 torch.from_numpy(x0), draws["t"], draws["e"], betas[1],
                                 {"dropout_masks": draws["dropout_masks"]})
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)
    pairs = list(leaf_pairs(grads, wgrads))
    top = max(float(np.abs(w).max()) for _, _, w in pairs)
    for path, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=0, atol=max(1e-4 * float(np.abs(w).max()), 1e-8 * top), err_msg=path)
    n = len(pairs)
    assert n == len(tree_leaves(tparams))
    np.testing.assert_allclose(float(global_norm(grads)), float(optax.global_norm(wgrads)), rtol=1e-5)


def _jax_chain(jcfg, jparams, betas, cfg_ns, x0, *, grad_clip, ema_rate, steps=STEPS):
    tx = j_get_optimizer(cfg_ns)
    step = jax.jit(j_make_train_step(jcfg, jnp.asarray(betas), tx, grad_clip=grad_clip, ema_rate=ema_rate))
    state = j_init_train_state(jparams, tx)
    keys, losses = [], []
    key = jax.random.PRNGKey(42)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys.append(sub)
        state, loss = step(state, jnp.asarray(x0), sub)
        losses.append(float(loss))
    return state, losses, keys


def _port_chain(tparams, betas, cfg_ns, x0, keys, *, grad_clip, ema_rate):
    cfg = UNetConfig(**TOY)
    tx = get_optimizer(cfg_ns)
    step = make_train_step(cfg, betas, tx, grad_clip=grad_clip, ema_rate=ema_rate)
    state = init_train_state(tparams, tx)
    losses = []
    for sub in keys:
        state, loss = step(state, torch.from_numpy(x0), **jax_step_draws(sub, cfg, x0.shape, T))
        losses.append(float(loss))
    return state, losses


def _assert_states_close(state, jstate, steps, lr=LR):
    """`training.compare_train_states` against JAX's state: params and EMA
    within 1e-6 of their scale on 99.9% of elements and 2 * lr * steps
    everywhere (a first Adam update is about lr * sign(g)); each moment or
    trace within 1e-5 of its own scale on 99.9%, the counts exactly."""
    res = compare_train_states(state, jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jstate), lr,
                               steps)
    assert res["ok"], res
    assert int(state.step) == steps


@pytest.mark.parametrize("name", ["Adam", "RMSProp", "SGD"])
def test_three_steps_match_jax(toy, betas, name):
    """Three steps with clipping active (the global norm is above 1 at the
    init) and the EMA on (rate 0.9, so that it moves): the losses (1e-5),
    params, optimizer state and EMA against JAX's make_train_step."""
    jcfg, jparams, tparams, x0 = toy
    cfg_ns = _optim(name, weight_decay=1e-3 if name != "SGD" else 0.0)
    jstate, jlosses, keys = _jax_chain(jcfg, jparams, betas[0], cfg_ns, x0, grad_clip=1.0, ema_rate=0.9)
    state, losses = _port_chain(tparams, betas[1], cfg_ns, x0, keys, grad_clip=1.0, ema_rate=0.9)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_states_close(state, jstate, STEPS)
    if name == "Adam":
        assert int(state.opt_state[0].count) == STEPS and state.opt_state[0].count.dtype == torch.int32
    # clipping was active: the first step's gradient norm is above the clip
    cfg = UNetConfig(**TOY)
    d = jax_step_draws(keys[0], cfg, x0.shape, T)
    _, grads = loss_and_grads(lambda p, x, tt, **rnd: unet_apply(p, cfg, x, tt, train=True, **rnd), tparams,
                              torch.from_numpy(x0), d["t"], d["e"], betas[1], {"dropout_masks": d["dropout_masks"]})
    assert float(global_norm(grads)) > 1.0


def test_no_clip_matches_jax(toy, betas):
    """grad_clip=None (imagenet64.yml, church.yml): SGD's unclipped steps against JAX's."""
    jcfg, jparams, tparams, x0 = toy
    cfg_ns = _optim("SGD", lr=1e-4)
    jstate, jlosses, keys = _jax_chain(jcfg, jparams, betas[0], cfg_ns, x0, grad_clip=None, ema_rate=0.9, steps=2)
    state, losses = _port_chain(tparams, betas[1], cfg_ns, x0, keys, grad_clip=None, ema_rate=0.9)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_states_close(state, jstate, 2, lr=1e-4)
    clipped, _ = _port_chain(tparams, betas[1], cfg_ns, x0, keys, grad_clip=1.0, ema_rate=0.9)
    assert not torch.equal(clipped.params["conv_out"]["kernel"], state.params["conv_out"]["kernel"])


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match="Adagrad"):
        get_optimizer(_optim("Adagrad"))
    with pytest.raises(NotImplementedError, match="Adagrad"):
        j_get_optimizer(_optim("Adagrad"))


def test_step_draws_from_a_generator(toy, betas):
    """Without handed-in draws the step takes t, e and the masks from its
    generator: the same seed gives the same state, another seed another;
    no generator and no t / e raises."""
    _, _, tparams, x0 = toy
    cfg = UNetConfig(**TOY)
    tx = get_optimizer(_optim("Adam"))
    step = make_train_step(cfg, betas[1], tx, ema_rate=None)
    a, la = step(init_train_state(tparams, tx, use_ema=False), torch.from_numpy(x0),
                 generator=torch.Generator().manual_seed(0))
    b, lb = step(init_train_state(tparams, tx, use_ema=False), torch.from_numpy(x0),
                 generator=torch.Generator().manual_seed(0))
    c, lc = step(init_train_state(tparams, tx, use_ema=False), torch.from_numpy(x0),
                 generator=torch.Generator().manual_seed(1))
    assert a.ema is None and torch.equal(la, lb) and not torch.equal(la, lc)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    assert dataclasses.fields(a)[0].name == "params"
    with pytest.raises(ValueError, match="generator"):
        step(a, torch.from_numpy(x0))


def test_flash_attention_refuses_autograd():
    """K11 has no backward, in JAX (jax.grad through its Pallas kernel fails
    to linearize) as in the port: at L = 1024, D = 128 `spatial_attention`
    (the flash route) raises when grad mode is on and an input requires
    grad, rather than return an output without a gradient; under no_grad,
    or without inputs that require grad, it runs."""
    from attentiondm_tpu.ops.attention import spatial_attention as j_spatial_attention
    from attentiondm_tpu_torch.ops.attention import flash_attention, spatial_attention, takes_flash

    assert takes_flash(1024, 128)
    q = np.random.default_rng(0).standard_normal((1, 1024, 128)).astype(np.float32)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda a: j_spatial_attention(a, a, a).sum())(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        spatial_attention(qt, qt, qt)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(qt, qt.detach(), qt.detach(), plain=True)
    with torch.no_grad():
        out = spatial_attention(qt, qt, qt)
    assert out.shape == (1, 1024, 128) and not out.requires_grad
    assert torch.equal(spatial_attention(qt.detach(), qt.detach(), qt.detach()), out)
    short = torch.from_numpy(q[:, :256]).requires_grad_(True)  # L = 256 takes the dense softmax, differentiable
    spatial_attention(short, short, short).sum().backward()
    assert short.grad is not None and torch.isfinite(short.grad).all()
