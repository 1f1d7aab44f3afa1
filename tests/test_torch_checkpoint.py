"""PyTorch port vs the JAX package: checkpoints.  JAX's self-describing
`.npz` both ways (a param tree, a training state's EMA / params, a tree of
dataclasses and None leaves), the reference's torch DDIM state dict
converted by name (bare, `module.`-prefixed, the training-states list with
EMA) against JAX's converter, and the registry lookup of `pretrained.py`
with no network."""
import dataclasses
import hashlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attentiondm_tpu import checkpoint as jckpt
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.models.torch_convert import load_torch_checkpoint as j_load_torch
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.training import init_train_state
from attentiondm_tpu_torch import checkpoint, pretrained
from attentiondm_tpu_torch.models.torch_convert import ddim_state_dict, load_torch_checkpoint
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_init
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}/{f.name}")
    else:
        yield path, tree


def assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        if w[k] is None:
            assert g[k] is None, k
            continue
        a = g[k].cpu().numpy() if torch.is_tensor(g[k]) else np.asarray(g[k])
        b = np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _like():
    return unet_init(torch.Generator().manual_seed(0), UNetConfig(**TINY), "cpu")


@pytest.fixture(scope="module")
def jparams():
    return j_unet_init(jax.random.PRNGKey(3), JConfig(**TINY))


def test_jax_params_npz_loads_bit_equal(tmp_path, jparams):
    """A param tree JAX's `save_checkpoint` wrote loads by name to the bit."""
    path = str(tmp_path / "params.npz")
    jckpt.save_checkpoint(path, jparams)
    assert_trees_equal(checkpoint.load_checkpoint(path, _like(), device="cpu"), jparams)
    assert_trees_equal(checkpoint.load_params(path, _like(), device="cpu"), jparams)


@pytest.mark.parametrize("use_ema", [True, False])
def test_jax_train_state_npz_gives_ema_else_params(tmp_path, jparams, use_ema):
    """A JAX training state (params, optax state, EMA, step): the port takes
    its `ema` subtree where the config that wrote it keeps one (`ema=`, the
    config's `model.ema`), else `params`, by name, with no optimizer object
    (tests/test_torch_train_ckpt.py holds the other pairings against JAX)."""
    state = init_train_state(jparams, optax.adam(1e-3), use_ema=use_ema)
    if use_ema:
        state = dataclasses.replace(state, ema=jax.tree_util.tree_map(lambda a: a * 0.5 + 1.0, jparams))
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_checkpoint(path, state)
    got = checkpoint.load_params(path, _like(), device="cpu", ema=use_ema)
    assert_trees_equal(got, state.ema if use_ema else state.params)


def test_port_npz_loads_in_jax(tmp_path, jparams):
    """A tree the port writes (params, a list, None, the quant states'
    dataclasses) loads in JAX's `load_checkpoint` to the bit."""
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    cfg = UNetConfig(**TINY)
    qstates = QuantizedUNet.create(cfg, 4, 8).init_state(3, "cpu")
    tree = {"params": params, "qstates": qstates, "none": None,
            "steps": [torch.arange(3, dtype=torch.int32), torch.ones(2, dtype=torch.int16)]}
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, tree)
    jq = JQuantizedUNet.create(JConfig(**TINY), bitwidth=4, a_bitwidth=8)
    like = {"params": jparams, "qstates": jq.init_state(3), "steps": [jnp.zeros(3), jnp.zeros(2)], "none": None}
    got = jckpt.load_checkpoint(path, like)
    assert_trees_equal(tree, got)
    # and back: the port's own reader
    assert_trees_equal(checkpoint.load_checkpoint(path, tree, device="cpu"), got)


def test_missing_key_is_named(tmp_path, jparams):
    path = str(tmp_path / "p.npz")
    jckpt.save_checkpoint(path, {"temb": jparams["temb"]})
    with pytest.raises(KeyError, match="conv_in/kernel"):
        checkpoint.load_checkpoint(path, _like(), device="cpu")


@pytest.fixture(scope="module")
def state_dict(jparams):
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return ddim_state_dict(params, UNetConfig(**TINY))


@pytest.mark.parametrize("form", ["bare", "module", "states_ema", "states_model"])
def test_torch_state_dict_converts_like_jax(tmp_path, jparams, state_dict, form):
    """A `torch.save`d reference-named state dict converts equal to JAX's
    `load_torch_checkpoint`, and to the params it was written from: bare,
    with DataParallel's `module.` prefix, and as the training-states list
    [model, optim, epoch, step, ema] (ema=True takes the last entry)."""
    sd = state_dict
    ema = False
    if form == "module":
        sd = {"module." + k: v for k, v in sd.items()}
    obj = sd
    if form.startswith("states"):
        ema_sd = {k: v * 0.5 for k, v in sd.items()}
        obj = [sd, {"state": {}, "param_groups": [{"lr": 2e-4, "params": [0, 1]}]}, 3, 1000, ema_sd]
        ema = form == "states_ema"
    path = str(tmp_path / "model.ckpt")
    torch.save(obj, path)
    got = load_torch_checkpoint(path, UNetConfig(**TINY), ema=ema, device="cpu")
    want = j_load_torch(path, JConfig(**TINY), ema=ema)
    assert_trees_equal(got, want)
    expect = jax.tree_util.tree_map(lambda a: a * 0.5, jparams) if ema else jparams
    assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, expect))


def test_renamed_key_raises_naming_it(tmp_path, state_dict):
    sd = dict(state_dict)
    sd["mid.attn_1.query.weight"] = sd.pop("mid.attn_1.q.weight")
    path = str(tmp_path / "bad.ckpt")
    torch.save(sd, path)
    with pytest.raises(KeyError, match=r"mid\.attn_1\.query\.weight.*mid\.attn_1\.q\.weight"):
        load_torch_checkpoint(path, UNetConfig(**TINY), device="cpu")


@pytest.fixture
def no_network(monkeypatch):
    """Any attempt to open a socket fails the test."""
    def refuse(*a, **k):
        raise AssertionError("pretrained.py opened a network connection")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


@pytest.mark.parametrize("where", ["root", "env", "cache"])
def test_get_ckpt_path_found_and_md5_checked(tmp_path, monkeypatch, no_network, where):
    """Found under `root`, `$ATTENTIONDM_CKPT_ROOT` or `~/.cache/attentiondm`
    (in that order); `check=True` verifies the registry's md5."""
    home = tmp_path / "home"
    base = home / ".cache" / "attentiondm" if where == "cache" else tmp_path / where
    f = base / pretrained.CKPT_MAP["cifar10"]
    f.parent.mkdir(parents=True)
    f.write_bytes(b"not the real checkpoint")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("ATTENTIONDM_CKPT_ROOT", raising=False)
    root = str(base) if where == "root" else None
    if where == "env":
        monkeypatch.setenv("ATTENTIONDM_CKPT_ROOT", str(base))
    assert pretrained.get_ckpt_path("cifar10", root=root) == str(f)
    with pytest.raises(ValueError, match="md5 mismatch"):
        pretrained.get_ckpt_path("cifar10", root=root, check=True)
    monkeypatch.setitem(pretrained.MD5_MAP, "cifar10", hashlib.md5(f.read_bytes()).hexdigest())
    assert pretrained.get_ckpt_path("cifar10", root=root, check=True) == str(f)


def test_get_ckpt_path_missing_raises_without_network(tmp_path, monkeypatch, no_network):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("ATTENTIONDM_CKPT_ROOT", str(tmp_path / "ckpts"))
    with pytest.raises(FileNotFoundError, match="82ed3067fd1002f5cf4c339fb80c4669"):
        pretrained.get_ckpt_path("cifar10")
    with pytest.raises(KeyError):
        pretrained.get_ckpt_path("imagenet")
    assert not (tmp_path / "ckpts").exists()  # nothing was created or fetched
