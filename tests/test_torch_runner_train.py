"""PyTorch port vs the JAX package: the runner's training half and `--test`
(`Diffusion.train()` / `test()` on the CPU), `main_torch.py`'s dispatch and
`tools/train_synthetic.py`.

Both runners train a toy (ch 64, 8x8, the SYNTHETIC dataset, batch 8,
dropout 0.1, Adam with clipping and EMA) for 3 steps from one initial state:
JAX's seeded init, written as a step-0 `ckpt.npz` that both load through
`--resume_training` (each package draws its own init).  The port's draws go
through `Diffusion.randomness`, replaced here by the draws JAX's runner
takes (PRNGKey(seed + 1), split once a step, then `split(sub, 3)` for t,
eps and the dropout masks; PRNGKey(seed) split per batch for `--test`).
Tolerances: the logged losses 1e-5 relative; the checkpoints as
tests/test_torch_training.py holds a step (params and EMA 1e-6 of their
scale on 99.9% of elements and 2 * lr * steps everywhere, the moments 1e-5,
the counts exactly); the eps-MSE of `--test` 1e-5 (float) and 2% (fake-quant
W4A8: activation codes on rounding ties flip, as in
tests/test_torch_runner.py)."""
import csv
import os

import jax
import numpy as np
import pytest
import torch

from attentiondm_tpu import checkpoint as jckpt
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.runners import Diffusion as JDiffusion
from attentiondm_tpu.training import get_optimizer as j_get_optimizer
from attentiondm_tpu.training import init_train_state as j_init_train_state
from attentiondm_tpu_torch import checkpoint
from attentiondm_tpu_torch.runners.diffusion import Diffusion
from attentiondm_tpu_torch.tools import train_synthetic
from attentiondm_tpu_torch.training import compare_train_states
from test_runner import tiny_config
from test_torch_runner import _args, jax_randomness
from test_torch_training import jax_step_draws

LR = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_config(n_iters=3):
    """tests/test_runner.py's tiny config at ch 64 and 8x8 (every GroupNorm group 2 channels or more), dropout
    0.1, 80 training images and 8 test images."""
    c = tiny_config(None)
    c.model.ch, c.model.dropout, c.data.image_size, c.data.num_synthetic = 64, 0.1, 8, 80
    c.training.n_iters, c.training.snapshot_freq = n_iters, 2
    return c


def jax_train_randomness(runner):
    """`Diffusion.randomness` with the draws JAX's runner takes: its training
    chain, its `--test` keys, and tests/test_torch_runner.py's streams."""
    seed = int(runner.args.seed)
    other = jax_randomness(runner)

    def randomness(stream, shape=None, index=0):
        if stream == "transform":
            return None, {}
        if stream == "train":
            key = jax.random.PRNGKey(seed + 1)
            for _ in range(index + 1):
                key, sub = jax.random.split(key)
            d = runner.config.data
            shape = (runner.config.training.batch_size, d.image_size, d.image_size, d.channels)
            return None, jax_step_draws(sub, runner.ucfg, shape, runner.num_timesteps)
        if stream == "test":
            key = jax.random.PRNGKey(seed)
            for _ in range(index + 1):
                key, kt, ke = jax.random.split(key, 3)
            t = jax.random.randint(kt, (shape[0],), 0, runner.num_timesteps)
            return torch.from_numpy(np.asarray(jax.random.normal(ke, shape))), {
                "t": torch.from_numpy(np.asarray(t)).to(torch.int64)}
        return other(stream, shape, index)

    return randomness


def _port(args, config):
    r = Diffusion(args, config, device="cpu")
    r.randomness = jax_train_randomness(r)
    return r


def _losses(log_path):
    with open(os.path.join(log_path, "train_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return [int(r["step"]) for r in rows], [float(r["loss"]) for r in rows]


def assert_ckpts_close(got_path, want_path, steps):
    """Two training-state files, read into the port's state by name, held by
    `training.compare_train_states` as a train step is."""
    assert checkpoint.read_flat(got_path).keys() == checkpoint.read_flat(want_path).keys()
    like = Diffusion(_args(os.path.dirname(got_path), "unused"), toy_config(), device="cpu")._train_state_like()
    got, want = (checkpoint.load_checkpoint(p, like, device="cpu") for p in (got_path, want_path))
    res = compare_train_states(got, want, LR, steps)
    assert res["ok"] and int(got.step) == steps, res


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX's runner and the port's, each trained 3 steps on its own exp tree
    from JAX's step-0 state (`--resume_training` on a `ckpt.npz` of it)."""
    out = {}
    for name in ("jax", "port"):
        tmp = tmp_path_factory.mktemp(name)
        args = _args(tmp, "unused", resume_training=True)
        config = toy_config()
        init = j_unet_init(jax.random.PRNGKey(args.seed), JConfig.from_config(config))
        jckpt.save_checkpoint(os.path.join(args.log_path, "ckpt.npz"),
                              j_init_train_state(init, j_get_optimizer(config)))
        if name == "jax":
            JDiffusion(args, config).train()
        else:
            r = _port(args, config)
            r.train()
            out["runner"] = r
        out[name] = args
    return out


def test_train_matches_jax_runner(trained):
    """3 steps: the logged losses, `ckpt_1.npz` and `ckpt.npz` (step 2: the
    last snapshot) against JAX's runner; the event file is written."""
    ja, ta = trained["jax"], trained["port"]
    jsteps, jl = _losses(ja.log_path)
    tsteps, tl = _losses(ta.log_path)
    assert tsteps == jsteps == [1, 2, 3]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_ckpts_close(os.path.join(ta.log_path, "ckpt_1.npz"), os.path.join(ja.log_path, "ckpt_1.npz"), 1)
    assert_ckpts_close(os.path.join(ta.log_path, "ckpt.npz"), os.path.join(ja.log_path, "ckpt.npz"), 2)
    assert sorted(f for f in os.listdir(ta.log_path) if f.endswith(".npz")) == ["ckpt.npz", "ckpt_1.npz",
                                                                                  "ckpt_2.npz"]
    events = os.listdir(os.path.join(ta.exp, "tensorboard", ta.doc))
    assert len(events) == 1 and events[0].startswith("events.out.tfevents.")
    r = trained["runner"]
    assert int(r.train_state.step) == 3 and len(r.step_seconds) == 3


def test_resume_training_continues_from_the_saved_step(trained, tmp_path, monkeypatch):
    """`--resume_training` with n_iters 5: the state loaded equals `ckpt.npz`
    (step 2), the first step logged is 3, the run ends at 5 with `ckpt_4`;
    its draws start again from the chain's first (JAX's runner restarts its
    key), so its losses and `ckpt_4` match JAX's resumed run."""
    import shutil

    runs = {}
    for name in ("jax", "port"):
        src = trained[name]
        args = _args(tmp_path / name, "unused", resume_training=True)
        shutil.copytree(src.log_path, args.log_path, dirs_exist_ok=True)
        saved = checkpoint.read_flat(os.path.join(args.log_path, "ckpt.npz"))
        config = toy_config(n_iters=5)
        if name == "jax":
            JDiffusion(args, config).train()
        else:
            r = _port(args, config)
            loaded = []
            orig = checkpoint.load_checkpoint

            def spy(*a, **kw):
                loaded.append(orig(*a, **kw))
                return loaded[-1]

            monkeypatch.setattr(checkpoint, "load_checkpoint", spy)
            r.train()
            flat = checkpoint._flatten(loaded[0])
            assert flat.keys() == saved.keys()
            for k in saved:
                if not k.endswith("__dc__"):
                    np.testing.assert_array_equal(flat[k], saved[k], err_msg=k)
            assert int(r.train_state.step) == 5
        runs[name] = args
    jsteps, jl = _losses(runs["jax"].log_path)
    tsteps, tl = _losses(runs["port"].log_path)
    assert tsteps == jsteps == [1, 2, 3, 3, 4, 5]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_ckpts_close(os.path.join(runs["port"].log_path, "ckpt_4.npz"),
                       os.path.join(runs["jax"].log_path, "ckpt_4.npz"), 4)


@pytest.mark.parametrize("mode", ["fp32", "fake_quant"])
def test_test_matches_jax(trained, tmp_path, mode):
    """`--test` on the 3-step checkpoint (its EMA, by the config): the eps-MSE
    over the test split against JAX's `test()`, with JAX's draws."""
    ckpt = os.path.join(trained["jax"].log_path, "ckpt.npz")
    kw = dict(fp32=True) if mode == "fp32" else dict(bitwidth=4, a_bitwidth=8)
    want = JDiffusion(_args(tmp_path / "j", "unused", ckpt_path=ckpt, **kw), toy_config()).test()
    r = _port(_args(tmp_path / "t", "unused", ckpt_path=ckpt, **kw), toy_config())
    got = r.test()
    assert r.test_result["seen"] == r.test_result["total"] == 8 and r.test_result["batches"] == 1
    np.testing.assert_allclose(got, want, rtol=1e-5 if mode == "fp32" else 2e-2)
    if mode == "fake_quant":
        assert r.test_result["steps_covered"] == 1 and r.test_result["desc"] == "fake-quant W4A8"


def test_fresh_run_from_the_port_init(tmp_path):
    """Without --resume_training the port starts from its own seeded init
    (`unet_init` from --seed): 3 steps, 3 CSV rows, finite falling-free
    losses, snapshots at 1 and 2, the state at step 3 with its EMA."""
    args = _args(tmp_path, "unused")
    r = Diffusion(args, toy_config(), device="cpu")
    r.train()
    steps, losses = _losses(args.log_path)
    assert steps == [1, 2, 3] and np.isfinite(losses).all()
    assert sorted(f for f in os.listdir(args.log_path) if f.endswith(".npz")) == ["ckpt.npz", "ckpt_1.npz",
                                                                                    "ckpt_2.npz"]
    state = r.train_state
    assert int(state.step) == 3 and state.ema is not None and int(state.opt_state[0].count) == 3
    assert int(checkpoint.read_flat(os.path.join(args.log_path, "ckpt.npz"))["step"]) == 2


def test_main_dispatch_without_a_card_returns_1(tmp_path, caplog):
    """`main_torch.main` without --sample trains, with --test tests; without a
    CUDA device either returns 1 after logging why."""
    import main_torch

    assert not torch.cuda.is_available()
    for extra in ([], ["--test"]):
        caplog.clear()
        rc = main_torch.main(["--config", "cifar10.yml", "--doc", "d", "--exp", str(tmp_path), "--ni", *extra])
        assert rc == 1 and "CUDA device" in caplog.text
    assert os.path.exists(os.path.join(str(tmp_path), "logs", "d", "config.yml"))


def test_train_synthetic_saves_loads_and_resumes(tmp_path):
    """`tools/train_synthetic.train` on the CPU: 3 steps of each
    distribution, the EMA tree at `out` (loaded by the runner through
    --ckpt_path), the state at `out.train.npz`, and `resume` from it;
    without `device="cpu"` it raises for want of a CUDA device."""
    from attentiondm_tpu_torch.models.unet import UNetConfig, tree_leaves

    cfg = UNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.1)
    with pytest.raises(RuntimeError, match="CUDA device"):  # no device named: the card's, and there is none
        train_synthetic.train(steps=1, batch=4, cfg=cfg)
    for dist in ("procedural", "natural"):
        out = str(tmp_path / f"{dist}.npz")
        state, losses = train_synthetic.train(steps=3, batch=4, seed=0, cfg=cfg, log_every=1, out=out, dist=dist,
                                              device="cpu")
        assert len(losses) == 3 and np.isfinite(losses).all() and int(state.step) == 3
        config = tiny_config(None)
        r = Diffusion(_args(tmp_path, "unused", ckpt_path=out), config, device="cpu")
        loaded = r._load_params()
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded), tree_leaves(state.ema)))
        again, _ = train_synthetic.train(steps=2, batch=4, seed=0, cfg=cfg, log_every=1, resume=out, dist=dist,
                                         device="cpu")
        assert int(again.step) == 5 and int(again.opt_state[0].count) == 5
