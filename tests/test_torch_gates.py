"""PyTorch port vs the JAX package: the UNet's architecture gates
(`unet_apply(gates=)`) and the DiffSearch ablation
(`tools/ablation_diffsearch.run_diff_search`), on toys of both attention
variants (the enhanced one's gamma set to 1: at JAX's init of 0 its blocks
are the identity and the attention gate has no effect).

Tolerances: the gated forward within 1e-5 relative (its mean abs error over
the mean |eps|), the gates' gradients within 1e-4 relative of `jax.grad`'s,
and `run_diff_search` on JAX's draws (x0, then each step's t and eps from
`fold_in(PRNGKey(seed + 2), i)`, handed in) within 1e-4 on every gate of
the trajectory and 1e-4 relative on every loss after 3 steps."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.config import dict2namespace as j_dict2namespace
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.tools import ablation_diffsearch as jds
from attentiondm_tpu_torch.config import load_config, namespace2dict
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params, unet_apply
from attentiondm_tpu_torch.tools import ablation_diffsearch as ds

TOYS = {"ddim": dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0),
        "enhanced": dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0,
                         attn_variant="enhanced")}
GATES = {"resblock": 0.7, "attention": 0.3, "temb": 1.6}
FWD_REL, GRAD_REL, TRAJ_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gamma(tree, value):
    if isinstance(tree, dict):
        return {k: np.full_like(v, value) if k == "gamma" else _gamma(v, value) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gamma(v, value) for v in tree]
    return tree


def _setup(variant):
    jcfg = JConfig(**TOYS[variant])
    np_params = _gamma(jax.tree_util.tree_map(np.asarray, j_unet_init(jax.random.PRNGKey(0), jcfg)), 1.0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([17.0, 640.0], np.float32)
    return jcfg, np_params, x, t


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).mean() / np.abs(np.asarray(b)).mean())


@pytest.mark.parametrize("variant", list(TOYS))
@pytest.mark.parametrize("which", ["all", "resblock", "attention", "temb"])
def test_gated_forward_matches_jax(variant, which):
    jcfg, np_params, x, t = _setup(variant)
    gates = GATES if which == "all" else {which: GATES[which]}
    want = j_unet_apply(np_params, jcfg, x, t, gates={k: jnp.float32(v) for k, v in gates.items()})
    got = unet_apply(from_jax_params(np_params, device="cpu"), UNetConfig(**TOYS[variant]), torch.tensor(x),
                     torch.tensor(t), gates={k: torch.tensor(v) for k, v in gates.items()})
    ungated = j_unet_apply(np_params, jcfg, x, t)
    assert _rel(got, want) < FWD_REL
    assert _rel(ungated, want) > 100 * FWD_REL  # the gate changed the output


@pytest.mark.parametrize("variant", list(TOYS))
@pytest.mark.parametrize("gates", [None, {}, {"other": 0.5}])
def test_absent_gates_leave_the_output_as_it_was(variant, gates):
    _, np_params, x, t = _setup(variant)
    params, cfg = from_jax_params(np_params, device="cpu"), UNetConfig(**TOYS[variant])
    plain = unet_apply(params, cfg, torch.tensor(x), torch.tensor(t))
    gated = unet_apply(params, cfg, torch.tensor(x), torch.tensor(t),
                       gates=None if gates is None else {k: torch.tensor(v) for k, v in gates.items()})
    assert torch.equal(plain, gated)


@pytest.mark.parametrize("variant", list(TOYS))
def test_gate_gradients_match_jax_grad(variant):
    jcfg, np_params, x, t = _setup(variant)
    e = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    logits = {k: np.float32(np.log(v / (2.0 - v)) if v < 2 else 0.4) for k, v in GATES.items()}

    def jloss(lg):
        g = {k: jax.nn.sigmoid(v) for k, v in lg.items()}
        return jnp.sum((j_unet_apply(np_params, jcfg, x, t, gates=g) - e) ** 2)

    jgrads = jax.grad(jloss)({k: jnp.float32(v) for k, v in logits.items()})
    params, cfg = from_jax_params(np_params, device="cpu"), UNetConfig(**TOYS[variant])
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in logits.items()}
    out = unet_apply(params, cfg, torch.tensor(x), torch.tensor(t),
                     gates={k: torch.sigmoid(v) for k, v in leaves.items()})
    torch.sum((out - torch.tensor(e)) ** 2).backward()
    for k in GATES:
        got, want = leaves[k].grad.item(), float(jgrads[k])
        assert abs(got - want) <= GRAD_REL * abs(want), (k, got, want)


def _toy_config():
    d = namespace2dict(load_config("ablation_config.yml"))
    d["data"]["image_size"] = 8
    d["model"].update(ch=64, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
    return d


def test_run_diff_search_matches_jax_on_its_draws(tmp_path):
    steps, batch, seed = 3, 2, 0
    d = _toy_config()
    config = j_dict2namespace(d)
    jcfg = JConfig.from_config(config)
    jparams = j_unet_init(jax.random.PRNGKey(seed), jcfg)
    pairs = dict(lambdas=(0.1,), etas=(0.05, 0.2))
    want = jds.run_diff_search(config, str(tmp_path / "jax"), params=jparams, steps=steps, batch=batch, seed=seed,
                               **pairs)
    shape = (batch, 8, 8, 3)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), shape))
    ts, es = [], []
    for i in range(steps):
        kt, ke = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed + 2), i))
        ts.append(np.asarray(jax.random.randint(kt, (batch,), 0, 1000)))
        es.append(np.asarray(jax.random.normal(ke, shape)))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = ds.run_diff_search(config, str(tmp_path / "port"), params=params, steps=steps, batch=batch, seed=seed,
                             device="cpu", x0=torch.tensor(x0), t=torch.tensor(np.stack(ts)),
                             e=torch.tensor(np.stack(es)), **pairs)
    assert list(got) == list(want) == ["lambda=0.1_eta=0.05", "lambda=0.1_eta=0.2"]
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w) == {"final_weights", "loss", "weights_evolution"}
        for k in ("resblock", "attention", "temb"):
            np.testing.assert_allclose(g["weights_evolution"][k], w["weights_evolution"][k], rtol=0, atol=TRAJ_TOL)
            assert g["final_weights"][k] == g["weights_evolution"][k][-1]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=TRAJ_TOL)
        assert g["weights_evolution"]["resblock"][0] != 0.5  # the gates moved
    with open(tmp_path / "port" / "diff_search_results.json") as f:
        assert json.load(f) == got
    assert (tmp_path / "port" / "weights_evolution.png").is_file()


def test_run_diff_search_own_draws_and_cli(tmp_path):
    """Without hand-ins the port draws from its generators (every pair the
    same draws: the first step's loss is the same); the CLI writes JAX's files."""
    import yaml

    d = _toy_config()
    cfg_path = tmp_path / "toy.yml"
    cfg_path.write_text(yaml.safe_dump(d))
    got = ds.run_diff_search(load_config(str(cfg_path)), str(tmp_path / "a"), lambdas=(0.0, 1.0), etas=(0.1,),
                             steps=2, batch=2, device="cpu", plot=False)
    (a, b) = got.values()
    assert a["loss"][0] < b["loss"][0]  # the same eps-MSE, plus lambda * sum(sigmoid(0)) = 1.5
    assert abs((b["loss"][0] - a["loss"][0]) - 1.5) < 1e-4
    assert not (tmp_path / "a" / "weights_evolution.png").exists()
    assert ds.main(["--config", str(cfg_path), "--out", str(tmp_path / "cli"), "--steps", "1", "--device", "cpu"]) == 0
    with open(tmp_path / "cli" / "diff_search_results.json") as f:
        assert set(json.load(f)) == {f"lambda={lam}_eta={eta}" for lam in (0.01, 0.1) for eta in (0.01, 0.05)}
