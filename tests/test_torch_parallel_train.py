"""PyTorch port vs the JAX package: sharded training, the runner over
several ranks, batch-sharded FID statistics and the multi-process smoke
(`training.make_sharded_train_step`, `runners/diffusion.py`,
`eval/fid.sharded_statistics(mesh=)`), on ranks spawned over gloo
(tests/torch_parallel_worker.py).

- The DP (2 ranks), dp 2 x tp 2 and dp 2 x sp 2 steps, two of each from
  JAX's init, on the t and eps JAX's step draws from its keys, against JAX's
  train step: each step's loss within rtol 1e-5 and the conv1 kernel within
  5e-5 after two steps (tests/test_tp.py's bounds for JAX's sharded step),
  every param, EMA and Adam moment by `compare_train_states`; under tp the
  kernels, moments and EMA live as shards.
- A tp step with dropout on a seeded generator equals the port's
  one-device step (the masks drawn whole, then cut to the shard).
- The runner at --tp 2 and --sp 2 on 2 ranks trains, writes JAX-keyed
  checkpoints of whole tensors (read back by JAX's `load_checkpoint`) equal
  to the one-rank runner's, and resumes; --tp 3 falls back to pure DP with
  JAX's warning.  A 2-rank --fid run at eta 0.5 through the serving path
  writes the bytes one rank writes.
- `sharded_statistics` over 2 ranks against JAX's on its 2-device mesh.
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attentiondm_tpu import checkpoint as jckpt
from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.eval import fid as jfid
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.parallel import make_mesh as j_make_mesh
from attentiondm_tpu.training import get_optimizer as j_get_optimizer
from attentiondm_tpu.training import init_train_state as j_init_train_state
from attentiondm_tpu.training import make_train_step as j_make_train_step
from attentiondm_tpu_torch import checkpoint
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, map_tree, unet_init
from attentiondm_tpu_torch.runners.diffusion import Diffusion
from attentiondm_tpu_torch.training import (TrainState, adamw, compare_train_states, init_train_state,
                                            make_train_step)
from test_runner import make_args, tiny_config
from test_torch_runner_train import toy_config
from test_torch_training import jax_step_draws
from torch_parallel_worker import spawn_ranks

TOY = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)
N, LR, STEPS = 8, 2e-4, 2
MESHES = {"dp": (2,), "tp": (2, 2), "sp": (2, 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's two steps on one device, and the port's on the spawned ranks of
    each mesh, from the same init, batch and draws."""
    jcfg = JConfig(**TOY)
    params = j_unet_init(jax.random.PRNGKey(0), jcfg)
    betas = JSchedule.create("linear", 1e-4, 0.02, 100).betas
    tx = optax.adamw(LR)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (N, 16, 16, 3)))
    step = jax.jit(j_make_train_step(jcfg, betas, tx, grad_clip=1.0, ema_rate=0.9999))
    state = j_init_train_state(params, tx)
    keys = [jax.random.PRNGKey(7 + i) for i in range(STEPS)]
    losses = []
    for k in keys:
        state, loss = step(state, jnp.asarray(x0), k)
        losses.append(float(loss))
    draws = []
    for k in keys:
        d = jax_step_draws(k, jcfg, x0.shape, 100)
        draws.append({"t": d["t"].numpy(), "e": d["e"].numpy()})
    payload = dict(cfg=TOY, params=_np(params), x0=x0, betas=np.asarray(betas), lr=LR, draws=draws)
    tmp = tmp_path_factory.mktemp("steps")
    got = {mode: spawn_ranks(tmp, int(np.prod(mesh)), "train", dict(payload, mode=mode, mesh=mesh))
           for mode, mesh in MESHES.items()}
    return dict(losses=losses, state=state, got=got)


def _port_state(res, jstate):
    """The port's gathered state as a TrainState beside JAX's (moments through optax's layout)."""
    dev = "cpu"
    return (TrainState(params=from_jax_params(res["params"], dev), opt_state=(from_jax_params(res["mu"], dev),
                                                                              from_jax_params(res["nu"], dev)),
                       ema=from_jax_params(res["ema"], dev), step=torch.tensor(STEPS)),
            TrainState(params=from_jax_params(_np(jstate.params), dev),
                       opt_state=(from_jax_params(_np(jstate.opt_state[0].mu), dev),
                                  from_jax_params(_np(jstate.opt_state[0].nu), dev)),
                       ema=from_jax_params(_np(jstate.ema), dev), step=torch.tensor(STEPS)))


@pytest.mark.parametrize("mode", list(MESHES))
def test_sharded_steps_match_jax(steps, mode):
    res = steps["got"][mode]
    for r in res:  # every rank reports the global loss
        np.testing.assert_allclose(r["losses"], steps["losses"], rtol=1e-5)
    want = np.asarray(steps["state"].params["down"][0]["block"][0]["conv1"]["kernel"])
    np.testing.assert_allclose(res[0]["params"]["down"][0]["block"][0]["conv1"]["kernel"], want, atol=5e-5)
    got, jst = _port_state(res[0], steps["state"])
    cmp = compare_train_states(got, jst, LR, STEPS)
    assert cmp["ok"], cmp
    local = (3, 3, 64, 32) if mode == "tp" else (3, 3, 64, 64)
    assert all(r["conv1_local"] == local and r["mu_local"] == local for r in res)


def test_tp_dropout_step_equals_one_device(tmp_path):
    """With dropout and a seeded generator every rank draws the whole
    batch's t, eps and masks, and keeps its slice: the tp step is the
    one-device step up to the collectives' order."""
    cfg = dict(TOY, dropout=0.1)
    params = unet_init(torch.Generator().manual_seed(3), UNetConfig(**cfg), "cpu")
    np_params = map_tree(lambda a: a.numpy(), params)
    betas = torch.linspace(1e-4, 0.02, 100)
    x0 = torch.randn((N, 16, 16, 3), generator=torch.Generator().manual_seed(4))
    tx = adamw(LR)
    step = make_train_step(UNetConfig(**cfg), betas, tx)
    state = init_train_state(params, tx)
    losses = []
    for s in range(STEPS):
        state, loss = step(state, x0, generator=torch.Generator().manual_seed(10 + s))
        losses.append(float(loss))
    res = spawn_ranks(tmp_path, 4, "train", dict(cfg=cfg, params=np_params, x0=x0.numpy(), betas=betas.numpy(), lr=LR,
                                                 mode="tp", mesh=(2, 2),
                                                 draws=[{"t": None, "e": None, "seed": 10 + s} for s in range(STEPS)]))
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    got = TrainState(params=from_jax_params(res[0]["params"], "cpu"), opt_state=(
        from_jax_params(res[0]["mu"], "cpu"), from_jax_params(res[0]["nu"], "cpu")),
        ema=from_jax_params(res[0]["ema"], "cpu"), step=torch.tensor(STEPS))
    want = TrainState(params=state.params, opt_state=(state.opt_state[0].mu, state.opt_state[0].nu), ema=state.ema,
                      step=torch.tensor(STEPS))
    cmp = compare_train_states(got, want, LR, STEPS)
    assert cmp["ok"], cmp


def test_pick_one_and_mesh_errors():
    """JAX's ValueError for spatial together with tensor parallelism, in both
    packages."""
    from attentiondm_tpu.parallel import unet_param_specs as j_specs
    from attentiondm_tpu.training import make_sharded_train_step as j_sharded
    from attentiondm_tpu_torch.parallel import make_mesh, unet_param_specs
    from attentiondm_tpu_torch.training import make_sharded_train_step

    jparams = j_unet_init(jax.random.PRNGKey(0), JConfig(**TOY))
    with pytest.raises(ValueError, match="pick one"):
        j_sharded(j_make_mesh(8, axes=("data", "model"), shape=(2, 4)), JConfig(**TOY), jnp.zeros(10),
                  optax.adamw(LR), spatial=True, param_specs=j_specs(jparams))
    params = from_jax_params(_np(jparams), "cpu")
    with pytest.raises(ValueError, match="pick one"):
        make_sharded_train_step(make_mesh(axes=("data", "model")), UNetConfig(**TOY), torch.zeros(10), adamw(LR),
                                spatial=True, param_specs=unet_param_specs(params))


def _toy_config(tmp, n_iters=3):
    """tests/test_torch_runner_train.py's toy: ch 64, 8x8, dropout 0.1, snapshots every 2 steps."""
    return toy_config(n_iters)


def _j_state_like():
    cfg = JConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.1)
    tx = j_get_optimizer(toy_config())
    return j_init_train_state(j_unet_init(jax.random.PRNGKey(0), cfg), tx)


@pytest.mark.parametrize("flag", ["tp", "sp"])
def test_runner_trains_snapshots_and_resumes(tmp_path, flag):
    """2 ranks at --tp 2 / --sp 2: the run logs its mesh, rank 0 writes
    ckpt.npz under JAX's keys with whole tensors (JAX's `load_checkpoint`
    reads it), equal to the one-rank runner's state; --resume_training
    re-shards it (step 2, the last snapshot) and trains on to step 5."""
    one = make_args(tmp_path / "one")
    Diffusion(one, _toy_config(tmp_path / "one"), device="cpu").train()
    a1 = make_args(tmp_path / "two", **{flag: 2})
    a2 = make_args(tmp_path / "two", resume_training=True, **{flag: 2})
    runs = [(a1, _toy_config(tmp_path / "two"), "train"), (a2, _toy_config(tmp_path / "two", 5), "train")]
    res = spawn_ranks(tmp_path, 2, "runner", {"runs": runs})
    first, resumed = res[0]
    assert any(f"dp1 x tp{2 if flag == 'tp' else 1} x sp{2 if flag == 'sp' else 1}" in m for m in first["log"])
    # snapshots every 2 steps: ckpt.npz holds step 2 when the first run ends at 3
    assert first["step"] == 3 and resumed["step"] == 5 and any("resumed from step 2" in m for m in resumed["log"])
    assert res[1][0]["conv1_local"] == ((3, 3, 64, 32) if flag == "tp" else (3, 3, 64, 64))
    path = os.path.join(a1.log_path, "ckpt_2.npz")
    jst = jckpt.load_checkpoint(path, _j_state_like())
    assert int(jst.step) == 2
    assert np.asarray(jst.params["down"][0]["block"][0]["conv1"]["kernel"]).shape == (3, 3, 64, 64)
    like = Diffusion(one, _toy_config(tmp_path / "one"), device="cpu")._train_state_like()
    mine = checkpoint.load_checkpoint(path, like, device="cpu")
    want = checkpoint.load_checkpoint(os.path.join(one.log_path, "ckpt_2.npz"), like, device="cpu")
    cmp = compare_train_states(mine, want, 2e-4, 2)
    assert cmp["ok"], cmp
    assert int(checkpoint.load_checkpoint(os.path.join(a1.log_path, "ckpt.npz"), like, device="cpu").step) == 4


def test_runner_tp_indivisible_falls_back(tmp_path, caplog):
    """--tp 3 divides neither the world (one rank here) nor the 32 groups:
    JAX's warning, then the pure-DP run."""
    args = make_args(tmp_path, tp=3)
    with caplog.at_level(logging.WARNING):
        Diffusion(args, _toy_config(tmp_path), device="cpu").train()
    assert any("falling back to pure DP" in r.message for r in caplog.records)
    assert os.path.exists(os.path.join(args.log_path, "ckpt.npz"))


def _fid_args(tmp, name):
    from test_torch_runner import _args

    return _args(tmp, name, fid=True, num_samples=8, execution="serving", eta=0.5, weight_opt="off")


@pytest.fixture(scope="module")
def one_rank_fid(tmp_path_factory):
    """The one-rank --fid run's image folder."""
    tmp = tmp_path_factory.mktemp("fid_one")
    one = _fid_args(tmp, "one")
    Diffusion(one, tiny_config(tmp), device="cpu").sample()
    return one.image_folder


@pytest.mark.parametrize("calib_cache", [None, "auto"])
def test_two_rank_fid_writes_one_ranks_bytes(tmp_path, one_rank_fid, calib_cache):
    """--fid --execution serving at eta 0.5 (per-step noise drawn whole,
    then sliced): the 2-rank run's PNGs are the one-rank run's, byte for
    byte, and its log gives img/s per device.  With --calib_cache auto (a
    log folder no run wrote before) rank 0 alone calibrates and writes the
    cache, which loads; rank 1 takes rank 0's calibration."""
    from attentiondm_tpu_torch.quant.calib_cache import load_calibration

    two = _fid_args(tmp_path, "two")
    two.calib_cache, two.log_path = calib_cache, os.path.join(str(tmp_path), "logs", "two")
    res = spawn_ranks(tmp_path, 2, "runner", {"runs": [(two, tiny_config(tmp_path), "sample")]})
    assert any("img/s/device" in m for m in res[0][0]["log"])
    names = sorted(os.listdir(one_rank_fid))
    assert names == sorted(os.listdir(two.image_folder)) and len(names) == 8
    for n in names:
        with open(os.path.join(one_rank_fid, n), "rb") as f1, open(os.path.join(two.image_folder, n), "rb") as f2:
            assert f1.read() == f2.read(), n
    calibrated = [any("stage-1 range calibration done" in m for m in r[0]["log"]) for r in res]
    saved = [sum("saved calibration cache" in m for m in r[0]["log"]) for r in res]
    assert calibrated == [True, False]
    assert saved == ([1, 0] if calib_cache else [0, 0])
    if calib_cache:
        cache = os.path.join(two.log_path, "calib_cache.npz")
        assert sorted(os.listdir(two.log_path)) == ["calib_cache.npz"]
        assert load_calibration(cache, two, Diffusion(two, tiny_config(tmp_path), device="cpu").make_seq(),
                                model_sig=str(UNetConfig.from_config(tiny_config(tmp_path))), device="cpu")


@pytest.mark.parametrize("mesh", [(2,), (2, 2), (1, 2)])
def test_sharded_statistics_match_jax_mesh(tmp_path, mesh):
    """f and f f^T summed in float32 over the data ranks (a batch of 5
    split 2 / 3) against JAX's `sharded_statistics` on its mesh of the same
    shape; the ranks of `model` repeat their data rank's share.
    `replicate` and `shard_batch` on the same ranks."""
    rng = np.random.default_rng(3)
    imgs = rng.random((21, 4, 4, 3)).astype(np.float32)
    proj = rng.standard_normal((3, 6)).astype(np.float32)
    n = int(np.prod(mesh))
    jmesh = j_make_mesh(n, axes=("data", "model")[:len(mesh)], shape=mesh)
    jmu, jsig = jfid.sharded_statistics(
        imgs, lambda x: jnp.tanh(x.reshape(x.shape[0], -1, 3).mean(axis=1) @ proj), mesh=jmesh, batch_size=8)
    res = spawn_ranks(tmp_path, n, "stats", dict(images=imgs, proj=proj, batch_size=8, mesh=mesh))
    for r in res:
        np.testing.assert_allclose(r["mu"], np.asarray(jmu), atol=1e-6)
        np.testing.assert_allclose(r["sigma"], np.asarray(jsig), atol=1e-6)
        np.testing.assert_array_equal(r["sigma"], res[0]["sigma"])
    # replicate broadcasts data-rank 0's leaves; shard_batch takes each data rank's contiguous slice
    assert [r["replicated"] for r in res] == [[0.0, 0.0]] * n
    step = 6 // mesh[0]
    assert [r["shard"] for r in res] == [list(range(6))[k // (n // mesh[0]) * step:][:step] for k in range(n)]


def test_two_process_train_and_serving(tmp_path):
    """tests/mp_smoke_worker.py's twin: 2 processes, one DP train step and
    one sharded W4A8 serving batch; the loss and the checksum, products of
    cross-rank collectives, agree on both ranks, and each rank served its
    half of the batch."""
    res = spawn_ranks(tmp_path, 2, "smoke", {})
    assert res[0]["loss"] == res[1]["loss"] and np.isfinite(res[0]["loss"])
    assert res[0]["checksum"] == res[1]["checksum"] and np.isfinite(res[0]["checksum"])
    assert res[0]["local"] == (2, 8, 8, 3)
    np.testing.assert_array_equal(res[0]["whole"], res[1]["whole"])
    assert res[0]["whole"].shape == (4, 8, 8, 3)
