"""PyTorch port vs the JAX package: spatial parallelism (sp) at levels whose
rows do not split into even slices (`parallel/tp.py` `sp_levels`,
`models/unet.py`'s level loop, `training.make_sharded_train_step`).

The toy attends at 8x8 and holds one row a rank at its 4x4 level before a
downsample when its height is split over 4 ranks.  JAX's GSPMD pads there;
the port gathers the rows before that downsample, runs the 2x2 level whole
on every rank, and cuts each rank's rows back out after the upsample.  The
sp forward (spawned gloo ranks, tests/torch_parallel_worker.py) is held to
JAX's `unet_apply` under `shard_batch_spatial` on a (1, 4) mesh of the 8
virtual CPU devices, and to the one-device forward of both packages, at
2e-5 (tests/test_tp.py's bound for JAX's sharded forward); its gradients
(params and x) to JAX's `jax.grad` within 1e-5 of each tree's largest
magnitude.  One sp train step with dropout equals the port's one-device
step by `compare_train_states`.  A level 0 that does not divide over the
ranks is refused, as JAX's `device_put` refuses it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.parallel import make_mesh as j_make_mesh
from attentiondm_tpu.parallel import replicate as j_replicate
from attentiondm_tpu.parallel import shard_batch_spatial as j_shard_batch_spatial
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_apply
from attentiondm_tpu_torch.parallel.tp import UNetParallel, describe_sp, sp_levels
from attentiondm_tpu_torch.training import TrainState, adamw, compare_train_states, init_train_state, make_train_step
from torch_parallel_worker import spawn_ranks

TOY = dict(ch=128, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
SP = 4
N = 2
FWD_TOL = 2e-5
GRAD_REL = 1e-5
LR = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    cfg = JConfig(**TOY)
    params = j_unet_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 8, 8, 3)).astype(np.float32)
    t = np.array([17.0, 480.0], np.float32)
    cot = rng.standard_normal((N, 8, 8, 3)).astype(np.float32)
    return cfg, params, x, t, cot


@pytest.fixture(scope="module")
def forwards(toy, tmp_path_factory):
    """JAX's eps on one device and under sp on a (1, 4) mesh, its gradients
    of sum(eps * cot), and the port's sp ranks' eps and gradients."""
    cfg, params, x, t, cot = toy

    def loss(p, xx):
        return jnp.sum(j_unet_apply(p, cfg, xx, jnp.asarray(t)) * cot)

    eps = np.asarray(jax.jit(lambda p, xx: j_unet_apply(p, cfg, xx, jnp.asarray(t)))(params, jnp.asarray(x)))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    mesh = j_make_mesh(SP, axes=("data", "model"), shape=(1, SP))
    eps_sp = jax.jit(lambda p, xx, tt: j_unet_apply(p, cfg, xx, tt),
                     out_shardings=NamedSharding(mesh, P("data", "model")))(
        j_replicate(mesh, params), j_shard_batch_spatial(mesh, jnp.asarray(x)), jnp.asarray(t))
    want = dict(eps=eps, eps_sp=np.asarray(eps_sp), grads=jax.tree_util.tree_map(np.asarray, gp), gx=np.asarray(gx))
    payload = dict(cfg=TOY, params=jax.tree_util.tree_map(np.asarray, params), x=x, t=t, cot=cot, mode="sp",
                   mesh=(1, SP))
    return want, spawn_ranks(tmp_path_factory.mktemp("sp_uneven"), SP, "forward", payload)


def test_the_plan_replicates_the_level_below_one_row_a_rank():
    """At 4 ranks the toy's 8x8 level holds 2 rows a rank, its 4x4 level 1
    row (odd, before a downsample): the 2x2 level runs whole."""
    cfg = UNetConfig(**TOY)
    assert sp_levels(cfg, SP) == 2 and UNetParallel(mode="sp", group=object(), size=SP).check_rows(cfg) == 2
    assert sp_levels(cfg, 2) == 3  # 4 and 2 rows a rank: every level splits
    assert describe_sp(cfg, SP) == ("sp 4: levels split over the ranks 0 (8x8, 2 row(s) a rank), 1 (4x4, 1 row(s) "
                                    "a rank); levels replicated on every rank 2 (2x2)")


def test_sp_forward_matches_jax_sp_and_one_device(forwards, toy):
    """The ranks' rows, stacked, against JAX's sp forward (GSPMD's padding)
    and the one-device forwards of both packages."""
    want, res = forwards
    cfg, params, x, t, _ = toy
    got = np.concatenate([r["eps"] for r in res], axis=1)
    assert all(r["eps"].shape == (N, 8 // SP, 8, 3) for r in res)
    np.testing.assert_allclose(want["eps_sp"], want["eps"], atol=FWD_TOL)  # JAX's sp runs here, GSPMD padding
    np.testing.assert_allclose(got, want["eps_sp"], atol=FWD_TOL)
    np.testing.assert_allclose(got, want["eps"], atol=FWD_TOL)
    port = unet_apply(from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu"), UNetConfig(**TOY),
                      torch.tensor(x), torch.tensor(t))
    np.testing.assert_allclose(got, port.numpy(), atol=FWD_TOL)


def test_sp_gradients_match_jax(forwards):
    """The gather's backward sums the ranks' gradients and the replicated
    levels' parameter gradients count once over the mesh: the params' and
    x's gradients equal JAX's, not the degree times them."""
    from attentiondm_tpu_torch.parallel.tp import _keystr, _map_with_path

    want, res = forwards
    ref = {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(want["grads"])}
    scale = max(float(np.abs(a).max()) for a in ref.values())
    for r in res:  # every rank holds the mesh's all-reduced gradient
        got = {}
        _map_with_path(lambda path, a: got.__setitem__(_keystr(path), a), r["grads"])
        assert set(got) == set(ref)
        worst = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
        assert worst <= GRAD_REL * scale, (worst, scale)
        # the deepest (replicated) level's conv: its gradient is the whole loss's, once
        k = "['down'][2]['block'][0]['conv1']['kernel']"
        assert np.abs(got[k] - ref[k]).max() <= GRAD_REL * np.abs(ref[k]).max()
    gx = np.concatenate([r["gx"] for r in res], axis=1)
    np.testing.assert_allclose(gx, want["gx"], atol=GRAD_REL * np.abs(want["gx"]).max())


def test_sp_train_step_matches_one_device(toy, tmp_path):
    """One dropout train step at sp 4 from JAX's init: the masks of the 2x2
    level stay whole, the rest are cut to the rank's rows; the state equals
    the port's one-device step on the same generator."""
    _, params, _, _, _ = toy
    cfg = dict(TOY, dropout=0.1)
    betas = np.asarray(JSchedule.create("linear", 1e-4, 0.02, 100).betas, np.float32)
    x0 = np.random.default_rng(1).standard_normal((N, 8, 8, 3)).astype(np.float32)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    res = spawn_ranks(tmp_path, SP, "train", dict(cfg=cfg, params=pnp, mode="sp", mesh=(1, SP), lr=LR,
                                                  betas=betas, x0=x0, draws=[{"seed": 5}]))
    tx = adamw(LR)
    step = make_train_step(UNetConfig(**cfg), torch.tensor(betas), tx)
    want, loss = step(init_train_state(from_jax_params(pnp, device="cpu"), tx), torch.tensor(x0),
                      generator=torch.Generator().manual_seed(5))
    assert all(r["losses"] == res[0]["losses"] for r in res)  # one loss, all-reduced, on every rank
    assert res[0]["losses"][0] == pytest.approx(float(loss), rel=1e-5)
    mine = TrainState(params=want.params, opt_state=(want.opt_state[0].mu, want.opt_state[0].nu), ema=want.ema,
                      step=torch.tensor(1))
    for r in res:
        got = TrainState(params=from_jax_params(r["params"], "cpu"), opt_state=(
            from_jax_params(r["mu"], "cpu"), from_jax_params(r["nu"], "cpu")),
            ema=from_jax_params(r["ema"], "cpu"), step=torch.tensor(1))
        cmp = compare_train_states(got, mine, LR)
        assert cmp["ok"], cmp


@pytest.mark.parametrize("size,height", [(4, 6), (8, 12)])
def test_level0_must_divide_as_in_jax(size, height):
    """Level 0's height not a multiple of the sp ranks: refused, naming the
    level, where JAX's `device_put` of the input under P(data, model)
    refuses it too."""
    mesh = j_make_mesh(size, axes=("data", "model"), shape=(1, size))
    with pytest.raises(ValueError, match=rf"should be divisible by {size}, but it is equal to {height}"):
        j_shard_batch_spatial(mesh, jnp.zeros((N, height, height, 3)))
    cfg = UNetConfig(**{**TOY, "resolution": height})
    with pytest.raises(ValueError, match=rf"level 0 \({height}x{height}\)"):
        sp_levels(cfg, size)
    with pytest.raises(ValueError, match=rf"level 0 \({height}x{height}\)"):
        UNetParallel(mode="sp", group=object(), size=size).check_rows(cfg)
