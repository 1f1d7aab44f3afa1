"""PyTorch port vs the JAX package: training-state checkpoints.

A `TrainState` (params, the optimizer state, EMA, step) of each optimizer
saves under the keys JAX's `save_checkpoint` writes (optax 0.2.6's state
tuples), with the same dtypes and shapes; a state either package writes
loads in the other to the bit.  The runners' `_load_params` take a training
state's `ema` or `params` by the config's `model.ema`, as JAX's does, and
both raise KeyError for `model.ema` on a state saved without an EMA."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from attentiondm_tpu import checkpoint as jckpt
from attentiondm_tpu.config import dict2namespace
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.runners import Diffusion as JDiffusion
from attentiondm_tpu.training import get_optimizer as j_get_optimizer
from attentiondm_tpu.training import init_train_state as j_init_train_state
from attentiondm_tpu_torch import checkpoint
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, map_tree
from attentiondm_tpu_torch.runners.diffusion import Diffusion
from attentiondm_tpu_torch.training import get_optimizer, init_train_state
from test_runner import make_args, tiny_config
from test_torch_checkpoint import assert_trees_equal

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)
OPTIMIZERS = ["Adam", "RMSProp", "SGD"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _optim(name):
    return dict2namespace({"optim": dict(optimizer=name, lr=2e-4, beta1=0.9, eps=1e-8, weight_decay=0.0)})


@pytest.fixture(scope="module")
def jparams():
    return j_unet_init(jax.random.PRNGKey(4), JConfig(**TINY))


def _filled(state, seed):
    """`state` with every float leaf of the optimizer state and EMA set to seeded values (a state that has trained)."""
    rng = np.random.default_rng(seed)
    fill = lambda a: torch.from_numpy(rng.standard_normal(tuple(a.shape)).astype(np.float32))  # noqa: E731

    def walk(node):
        if isinstance(node, tuple):
            return type(node)(*(walk(v) for v in node)) if hasattr(node, "_fields") else tuple(walk(v) for v in node)
        if isinstance(node, (dict, list)):
            return map_tree(lambda a: fill(a) if a.dtype == torch.float32 else a + 7, node)
        return node + 7 if torch.is_tensor(node) else node

    return dataclasses.replace(state, opt_state=walk(state.opt_state), ema=map_tree(fill, state.ema),
                               step=state.step + 7)


def _port_state(jparams, name, use_ema=True):
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return _filled(init_train_state(params, get_optimizer(_optim(name)), use_ema=use_ema), seed=len(name))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_keys_dtypes_and_shapes_equal_jax(tmp_path, jparams, name):
    """The port's file holds JAX's keys, each with JAX's dtype and shape
    (the `/__dc__` marker's bytes name each package's own class)."""
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(jpath, j_init_train_state(jparams, j_get_optimizer(_optim(name))))
    checkpoint.save_checkpoint(tpath, _port_state(jparams, name))
    want, got = checkpoint.read_flat(jpath), checkpoint.read_flat(tpath)
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("__dc__"):
            continue
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
    opt_keys = sorted(k for k in want if k.startswith("opt_state") and "/down/" not in k and "/up/" not in k
                      and "/mid/" not in k and "/temb/" not in k and "conv_" not in k and "norm_out" not in k)
    expected = {"Adam": ["opt_state/0/0", "opt_state/0/__len__", "opt_state/1/__len__", "opt_state/2/__len__",
                         "opt_state/__len__"],
                "RMSProp": ["opt_state/0/__len__", "opt_state/1/0/__len__", "opt_state/1/1/__len__",
                            "opt_state/1/2/__len__", "opt_state/1/__len__", "opt_state/__len__"],
                "SGD": ["opt_state/0/__len__", "opt_state/1/__len__", "opt_state/__len__"]}[name]
    assert opt_keys == expected
    moment = {"Adam": "opt_state/0/1/", "RMSProp": "opt_state/1/0/0/", "SGD": "opt_state/0/0/"}[name]
    assert f"{moment}conv_in/kernel" in got and want[f"{moment}conv_in/kernel"].shape == (3, 3, 3, 32)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_port_state_loads_in_jax(tmp_path, jparams, name):
    """A state the port wrote loads in JAX's `load_checkpoint` with JAX's
    like-tree (optax's namedtuples) to the bit, and back in the port's."""
    path = str(tmp_path / "ckpt.npz")
    state = _port_state(jparams, name)
    checkpoint.save_checkpoint(path, state)
    got = jckpt.load_checkpoint(path, j_init_train_state(jparams, j_get_optimizer(_optim(name))))
    assert_trees_equal(state, got)
    back = checkpoint.load_checkpoint(path, init_train_state(
        from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), get_optimizer(_optim(name))),
        device="cpu")
    assert_trees_equal(back, got)
    assert type(back.opt_state[0]) is type(state.opt_state[0])


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_jax_state_loads_in_port(tmp_path, jparams, name):
    """A state JAX wrote (after a step of its optimizer, EMA on and off) loads in the port to the bit."""
    tx = j_get_optimizer(_optim(name))
    for use_ema in (True, False):
        jstate = j_init_train_state(jparams, tx, use_ema=use_ema)
        grads = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.1, jparams)
        _, opt = tx.update(grads, jstate.opt_state, jstate.params)
        jstate = dataclasses.replace(jstate, opt_state=opt, step=jstate.step + 3)
        path = str(tmp_path / f"j{use_ema}.npz")
        jckpt.save_checkpoint(path, jstate)
        like = init_train_state(from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                                get_optimizer(_optim(name)), use_ema=use_ema)
        got = checkpoint.load_checkpoint(path, like, device="cpu")
        assert_trees_equal(got, jstate)
        assert got.step.dtype == torch.int32 and int(got.step) == 3


@pytest.mark.parametrize("file_ema", [True, False])
@pytest.mark.parametrize("config_ema", [True, False])
def test_load_params_follows_config_ema(tmp_path, jparams, file_ema, config_ema):
    """Both runners' `_load_params` on one JAX training state: `ema` where
    the config's `model.ema` is set, else `params`, whatever the file holds;
    `model.ema` on a state saved without an EMA raises KeyError in both."""
    jstate = j_init_train_state(jparams, j_get_optimizer(_optim("Adam")), use_ema=file_ema)
    if file_ema:
        jstate = dataclasses.replace(jstate, ema=jax.tree_util.tree_map(lambda a: a * 0.5 + 1.0, jparams))
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_checkpoint(path, jstate)
    config = tiny_config(None)
    config.model.ema = config_ema
    args = make_args(tmp_path, ckpt_path=path, attn_variant="ddim")
    runners = (JDiffusion(args, config), Diffusion(args, config, device="cpu"))
    if config_ema and not file_ema:
        for r in runners:
            with pytest.raises(KeyError, match="ema/"):
                r._load_params()
        return
    want = jstate.ema if config_ema else jstate.params
    jgot, got = (r._load_params() for r in runners)
    assert_trees_equal(jgot, want)
    assert_trees_equal(got, want)
    assert_trees_equal(checkpoint.load_params(path, map_tree(lambda a: a, got), device="cpu", ema=config_ema), want)
