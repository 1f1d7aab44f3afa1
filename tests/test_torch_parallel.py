"""PyTorch port vs the JAX package: the parallel runtime's mesh, bootstrap,
tensor-parallel specs and the sharded forwards (`attentiondm_tpu_torch/parallel`).

JAX drives the 8 virtual CPU devices of tests/conftest.py from one
process; the port runs one process a rank, spawned here over gloo through a
FileStore (tests/torch_parallel_worker.py, which imports no JAX).  The
specs and `sharded_fraction` equal JAX's leaf for leaf; the tp forward
(dp 2 x tp 2, both attention variants) and the sp forward (sp 2 and 4) give
JAX's `unet_apply` eps within 2e-5 (tests/test_tp.py's bound for JAX's own
sharded forward), and their gradients JAX's `jax.grad` within 1e-5 of each
tree's largest magnitude; JAX's ValueErrors are raised where JAX raises them.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.parallel import make_mesh as j_make_mesh
from attentiondm_tpu.parallel import shard_unet_params as j_shard_unet_params
from attentiondm_tpu.parallel import sharded_fraction as j_sharded_fraction
from attentiondm_tpu.parallel import unet_param_specs as j_unet_param_specs
from attentiondm_tpu_torch.models.unet import from_jax_params
from attentiondm_tpu_torch.parallel import (initialize_distributed, make_mesh, shard_unet_params, sharded_fraction,
                                            unet_param_specs)
from attentiondm_tpu_torch.parallel.mesh import Mesh
from torch_parallel_worker import spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ch 64 so that a tp-2 shard of every GroupNorm holds whole groups of 2 channels; attention at 8x8
TOY = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)
N = 4
FWD_TOL = 2e-5
GRAD_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_toy(variant):
    cfg = JConfig(**TOY, attn_variant=variant)
    params = j_unet_init(jax.random.PRNGKey(0), cfg)
    if variant == "enhanced":  # JAX's init sets gamma to 0, every block the identity
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.full_like(a, 0.5) if getattr(p[-1], "key", None) == "gamma" else a, params)
    return cfg, params


def _spec_dim(spec):
    dims = [i for i, s in enumerate(spec) if s is not None]
    return dims[0] if dims else None


@pytest.mark.parametrize("variant", ["ddim", "enhanced"])
def test_param_specs_equal_jax(variant):
    """Leaf for leaf the split dimension of JAX's PartitionSpec (JAX flattens
    dicts in key order, the port in insertion order: compared by path)."""
    _, jparams = _jax_toy(variant)
    jspecs = j_unet_param_specs(jparams)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    specs = unet_param_specs(params)
    want = {jax.tree_util.keystr(p): _spec_dim(s) for p, s in
            jax.tree_util.tree_leaves_with_path(jspecs, is_leaf=lambda x: isinstance(x, P))}
    from attentiondm_tpu_torch.parallel.tp import _keystr, _map_with_path

    got = {}
    _map_with_path(lambda path, dim: got.__setitem__(_keystr(path), dim), specs)
    assert got == want
    blk = specs["down"][0]["block"][0]
    assert (blk["conv1"]["kernel"], blk["conv1"]["bias"], blk["conv2"]["kernel"], blk["conv2"]["bias"],
            blk["temb_proj"]["kernel"], blk["norm2"]["scale"], blk["norm1"]["scale"]) == (3, 0, 2, None, 1, 0, None)


@pytest.mark.parametrize("variant", ["ddim", "enhanced"])
def test_sharded_fraction_equals_jax(variant):
    _, jparams = _jax_toy(variant)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = sharded_fraction(params, unet_param_specs(params))
    assert got == pytest.approx(j_sharded_fraction(jparams, j_unet_param_specs(jparams)), rel=1e-12)
    assert got > 0.55


def _mesh(shape, coords=None):
    axes = ("data", "model")
    return Mesh(shape=dict(zip(axes, shape)), coords=coords or dict.fromkeys(axes, 0), groups=dict.fromkeys(axes),
                ranks=tuple(range(int(np.prod(shape)))))


def test_tp_degree_must_divide_groups():
    _, jparams = _jax_toy("ddim")
    with pytest.raises(ValueError, match="GroupNorm"):
        j_shard_unet_params(j_make_mesh(6, axes=("data", "model"), shape=(2, 3)), jparams)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    with pytest.raises(ValueError, match="GroupNorm"):
        shard_unet_params(_mesh((2, 3)), params)


def test_indivisible_leaf_is_named():
    """A split dimension the degree does not divide raises, naming the leaf
    (conv_in has 36 output channels here, so every level's conv1 is off)."""
    cfg = JConfig(**{**TOY, "ch": 36})
    jparams = j_unet_init(jax.random.PRNGKey(0), cfg)
    with pytest.raises(ValueError, match="not divisible by tp degree 8"):
        j_shard_unet_params(j_make_mesh(8, axes=("data", "model"), shape=(1, 8)), jparams)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    with pytest.raises(ValueError, match=r"^\['down'\]\[0\]\['block'\]\[0\]\['conv1'\]\['(kernel|bias)'\]: dim [03] "
                                         r"\(36\) not divisible by tp degree 8$"):
        shard_unet_params(_mesh((1, 8)), params)


def test_shards_are_contiguous_slices():
    _, jparams = _jax_toy("ddim")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    k = params["down"][0]["block"][0]["conv2"]["kernel"]
    for i in range(2):
        local = shard_unet_params(_mesh((1, 2), {"data": 0, "model": i}), params)
        blk = local["down"][0]["block"][0]
        assert torch.equal(blk["conv2"]["kernel"], k[:, :, 32 * i:32 * (i + 1)])
        assert blk["conv2"]["bias"] is params["down"][0]["block"][0]["conv2"]["bias"]
        assert blk["conv1"]["kernel"].shape == (3, 3, 64, 32) and blk["norm2"]["scale"].shape == (32,)


def test_mesh_checks_on_one_rank():
    """Without a process group the world is one rank: JAX's checks, and a
    2-D mesh of (1, 1)."""
    with pytest.raises(ValueError, match="does not cover"):
        j_make_mesh(8, axes=("data", "model"), shape=(2, 2))
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(1, axes=("data", "model"), shape=(2, 2))
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        j_make_mesh(9)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2)
    m = make_mesh(axes=("data", "model"))
    assert m.shape == {"data": 1, "model": 1} and m.coords == {"data": 0, "model": 0} and m.size == 1
    assert dict(j_make_mesh(8, axes=("data", "model")).shape) == {"data": 4, "model": 2}


def test_initialize_noop_without_coordinator(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False


def test_initialize_reraises_genuine_failures(monkeypatch):
    """A bootstrap failure raises; only re-initialisation is benign."""
    import torch.distributed as dist

    def boom(*a, **kw):
        raise RuntimeError("connect failed")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="connect failed"):
        initialize_distributed("localhost:1", num_processes=2, process_id=1, device="cpu")

    def again(*a, **kw):
        raise RuntimeError("trying to initialize the default process group twice!")

    monkeypatch.setattr(dist, "init_process_group", again)
    assert initialize_distributed("localhost:1", num_processes=2, process_id=1, device="cpu") in (True, False)


@pytest.mark.parametrize("local_world, device, want", [
    (1, None, ("cuda:0", "nccl")),
    (2, None, "2 ranks on this host and 1 visible card"),
    (2, "cuda:0", ("cuda:0", "gloo")),
])
def test_ranks_share_a_card_only_when_asked(monkeypatch, local_world, device, want):
    """More ranks on a host than cards is refused unless the caller names
    the card they share (then gloo); one rank a card joins over NCCL."""
    from attentiondm_tpu_torch.parallel.distributed import _pick_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=want):
            _pick_device(device, local_world)
    else:
        dev, backend = _pick_device(device, local_world)
        assert (str(dev), backend) == want
    assert _pick_device("cpu", local_world) == (torch.device("cpu"), "gloo")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_connect_deadline_dies_loudly():
    """A rank dialing a coordinator that never answers fails when its
    deadline passes: a non-zero exit with the timeout in its error, not a
    single-process fallback."""
    code = ("from attentiondm_tpu_torch.parallel import initialize_distributed;"
            f"initialize_distributed('localhost:{_free_port()}', num_processes=2, process_id=1,"
            " initialization_timeout=5, device='cpu');"
            "print('SWALLOWED')")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0, p.stdout + p.stderr
    assert "SWALLOWED" not in p.stdout
    assert "timed out" in p.stderr.lower() or "timeout" in p.stderr.lower(), p.stderr[-500:]


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """JAX's eps and gradients of sum(eps * cot) (params and x) on one
    device, and the port's from the spawned ranks: tp on a (2, 2) mesh for
    both variants, sp on (1, 2) and (1, 4)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 16, 16, 3)).astype(np.float32)
    t = np.array([17.0, 123.0, 480.0, 999.0], np.float32)
    cot = rng.standard_normal((N, 16, 16, 3)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("fwd")
    out = {}
    for variant in ("ddim", "enhanced"):
        cfg, params = _jax_toy(variant)

        def loss(p, xx):
            return jnp.sum(j_unet_apply(p, cfg, xx, jnp.asarray(t)) * cot)

        eps = np.asarray(j_unet_apply(params, cfg, jnp.asarray(x), jnp.asarray(t)))
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        want = dict(eps=eps, grads=jax.tree_util.tree_map(np.asarray, gp), gx=np.asarray(gx))
        payload = dict(cfg=dict(TOY, attn_variant=variant), params=jax.tree_util.tree_map(np.asarray, params), x=x,
                       t=t, cot=cot)
        runs = [("tp", (2, 2))] + ([("sp", (1, 2)), ("sp", (1, 4))] if variant == "ddim" else [])
        for mode, mesh in runs:
            out[(variant, mode, mesh)] = (want, spawn_ranks(tmp, int(np.prod(mesh)), "forward",
                                                            dict(payload, mode=mode, mesh=mesh)))
    return out


def _whole(mode, res, key):
    if mode == "tp":  # ranks (d, m): data-major; every model rank holds the same eps
        return np.concatenate([r[key] for r in res if r["coords"]["model"] == 0])
    return np.concatenate([r[key] for r in res], axis=1)


def _grads_close(got_tree, want_tree):
    """Every leaf within GRAD_REL of the tree's largest gradient magnitude,
    compared by path (the port keeps the init's key order)."""
    from attentiondm_tpu_torch.parallel.tp import _keystr, _map_with_path

    want = {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(want_tree)}
    got = {}
    _map_with_path(lambda path, a: got.__setitem__(_keystr(path), a), got_tree)
    assert set(got) == set(want)
    scale = max(float(np.abs(a).max()) for a in want.values())
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= GRAD_REL * scale, (worst, scale)


@pytest.mark.parametrize("variant", ["ddim", "enhanced"])
def test_tp_forward_matches_jax(forwards, variant):
    want, res = forwards[(variant, "tp", (2, 2))]
    np.testing.assert_allclose(_whole("tp", res, "eps"), want["eps"], atol=FWD_TOL)
    assert all(r["conv1_local"] == (3, 3, 64, 32) for r in res)
    # the model ranks of one data rank hold the same (replicated) eps, bit for bit
    assert np.array_equal(res[0]["eps"], res[1]["eps"]) and np.array_equal(res[2]["eps"], res[3]["eps"])


@pytest.mark.parametrize("variant", ["ddim", "enhanced"])
def test_tp_gradients_match_jax(forwards, variant):
    """Megatron's f / g pair: the gradients of the whole params (the
    shards' gathered) and of x equal JAX's, not the degree times them."""
    want, res = forwards[(variant, "tp", (2, 2))]
    _grads_close(res[0]["grads"], want["grads"])
    np.testing.assert_allclose(_whole("tp", res, "gx"), want["gx"], atol=GRAD_REL * np.abs(want["gx"]).max())


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)])
def test_sp_forward_and_gradients_match_jax(forwards, mesh):
    """Image height over 2 and 4 ranks: halo rows, the downsample's row from
    below, GroupNorm's all-reduced sums, K / V gathered."""
    want, res = forwards[("ddim", "sp", mesh)]
    np.testing.assert_allclose(_whole("sp", res, "eps"), want["eps"], atol=FWD_TOL)
    _grads_close(res[0]["grads"], want["grads"])
    np.testing.assert_allclose(_whole("sp", res, "gx"), want["gx"], atol=GRAD_REL * np.abs(want["gx"]).max())
    assert all(r["eps"].shape == (N, 16 // mesh[1], 16, 3) for r in res)


def test_sp_rows_must_divide():
    """Level 0's height must divide over the sp ranks (ValueError, naming
    it, as JAX's device_put refuses it); a deeper level whose rows a rank
    are odd before a downsample no longer raises: `check_rows` returns the
    first level that runs whole on every rank (GSPMD pads there)."""
    from attentiondm_tpu_torch.models.unet import UNetConfig
    from attentiondm_tpu_torch.parallel.tp import UNetParallel

    par = UNetParallel(mode="sp", group=object(), size=4)
    assert par.check_rows(UNetConfig(**TOY)) == 2  # 16 / 4 = 4 rows, then 8 / 4 = 2: every level splits
    assert par.check_rows(UNetConfig(**{**TOY, "ch_mult": (1, 2, 2)})) == 3  # the last level may hold 1 row a rank
    # level 2 (4x4) holds 1 row a rank, which cannot downsample: the rows are gathered before it, level 3 runs whole
    assert par.check_rows(UNetConfig(**{**TOY, "ch_mult": (1, 2, 2, 2)})) == 3
    with pytest.raises(ValueError, match=r"level 0 \(12x12\)"):
        UNetParallel(mode="sp", group=object(), size=8).check_rows(UNetConfig(**{**TOY, "resolution": 12}))
