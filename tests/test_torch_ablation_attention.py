"""PyTorch port vs the JAX package: the attention-precision ablation
(`tools/ablation_attention.py`): the four variants' bit policies, each
variant's stage-1 states on the trajectory JAX's run calibrated on, and the
whole run's FID rows on JAX's draws, on a toy (ch 64, one level at 8^2,
attention at 8^2), DDIM-3, 32 samples a model at batch 16, calibration
batch 2, the mean-colour features.

The policies are equal.  The states are held conv by conv on JAX's inputs
(5e-7, as tests/test_torch_calibrate.py), and whole at the first conv.
These are chained-quantizer toys (ROADMAP Queue 3): one fake-quant code that
rounds the other way moves the next conv's input, so later convs' ranges,
and with them the samples, drift from JAX's.

JAX draws each variant's noise from `fold_in(key, hash(name) % 997)`, and
`hash` of a str is salted per process by PYTHONHASHSEED, so JAX's rows moved
from run to run.  Swept over PYTHONHASHSEED 1 to 44 on the CPU (each run
alone, the bounds as below): 42 passed; 15 and 33 failed on row A's FID
(49.1% and 38.5% from JAX's, at JAX rows of 1.09e-3 and 8.1e-4), every pixel
difference within its bound (A at most 8.8 of 255).  Over the 44 salts the
FID rows moved from 3e-4 to 5e-3, and the largest differences from JAX were
A 49.1%, B 22.8%, C 8.0%, D 2.4%.  Replayed at salts 15 and 33 with JAX's own
calibrated states, the port's variant-A FID lies within 1e-5 and 2.7% of
JAX's (49.1% and 38.5% with its own states); teacher-forced on JAX's
trajectory with JAX's states, its eps equals JAX's to 1e-6 at every step but
one, where a fake-quant code on a rounding tie flips and spreads through the
forward's later quantizers.  So the port does not depart from JAX given
JAX's inputs: the spread is chained-quantizer drift.  The
test now gives JAX's module a salt-free `hash` (crc32 of the name,
`salt_free_hash`), so JAX takes the same draws in every process; at that
draw the rows are within 2.0% (A), 9.5% (B), 1.0% (C) and 0.05% (D) of
JAX's, the pixels 7.0, 4.6, 1.1 and 0.40 of 255.  Held: `FID_REL` and
`PIXEL_DIFF`, as before."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from attentiondm_tpu.config import dict2namespace as j_dict2namespace
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.models.unet import conv2d as j_conv2d
from attentiondm_tpu.quant import QuantizedUNet as JQuantizedUNet
from attentiondm_tpu.quant import calibrate_ranges as j_calibrate_ranges
from attentiondm_tpu.quant.calibrate import _calibrate_one_conv as j_calibrate_one_conv
from attentiondm_tpu.tools import ablation_attention as jab
from attentiondm_tpu_torch.config import load_config, namespace2dict
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params
from attentiondm_tpu_torch.quant.calibrate import _calibrate_one_conv
from attentiondm_tpu_torch.tools import ablation_attention as ab
from attentiondm_tpu_torch.utils.images import read_png

STEPS, SAMPLES, BATCH, CALIB, SEED = 3, 32, 16, 2, 0
FIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")
FID_REL = 0.3


def salt_free_hash(name: str) -> int:
    """Stands in for `hash` in JAX's ablation module: the variant names are
    ASCII, and their crc32 is the same in every process (`hash` of a str is
    salted by PYTHONHASHSEED)."""
    return zlib.crc32(name.encode())
PIXEL_DIFF = {"A_uniform_low": 16.0, "B_conv_low_attn_high": 12.0, "C_conv_high_attn_low": 2.5,
              "D_uniform_high": 1.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy():
    d = namespace2dict(load_config("cifar10.yml"))
    d["data"]["image_size"] = 8
    d["model"].update(ch=64, ch_mult=[1], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
    return d


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """JAX's whole run (each variant's `calibrate_ranges` call recorded: its
    trajectory inputs and states), its params and its draws."""
    config = j_dict2namespace(_toy())
    jcfg = JConfig.from_config(config)
    jparams = j_unet_init(jax.random.PRNGKey(SEED), jcfg)
    acfg = dict(sampler="ddim", steps=STEPS, num_samples=SAMPLES, batch=BATCH, calib_batch=CALIB, seed=SEED)
    out = tmp_path_factory.mktemp("jax_ablation")
    calls = []

    def recording(qunet, params, qstates, xs_in, seq, **kw):
        qs = j_calibrate_ranges(qunet, params, qstates, xs_in, seq, **kw)
        calls.append((np.asarray(xs_in), list(seq), qs))
        return qs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jab, "calibrate_ranges", recording)
        mp.setattr(jab, "hash", salt_free_hash, raising=False)
        rows = jab.run_attention_ablation(config, str(out), params=jparams, ablation_cfg=jab.AblationConfig(**acfg))

    shape = (jcfg.resolution, jcfg.resolution, jcfg.in_channels)
    key = jax.random.PRNGKey(SEED + 1)

    def initial(k):
        xs, done = [], 0
        while done < SAMPLES:
            n = min(BATCH, SAMPLES - done)
            k, k1, _ = jax.random.split(k, 3)
            xs.append(np.asarray(jax.random.normal(k1, (n, *shape))))
            done += n
        return np.concatenate(xs)

    x_init = {"fp": initial(key),
              **{v: initial(jax.random.fold_in(key, salt_free_hash(v) % 997)) for v in jab.VARIANTS}}
    x_cal = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED + 2), (CALIB, *shape)))
    return dict(config=config, jcfg=jcfg, rows=rows, acfg=acfg, x_init=x_init, x_cal=x_cal,
                calls=dict(zip(jab.VARIANTS, calls)), np_params=jax.tree_util.tree_map(np.asarray, jparams), out=out)


def test_variant_policies_equal_jax(chain):
    cfg = UNetConfig.from_config(chain["config"])
    assert list(ab.VARIANTS.items()) == list(jab.VARIANTS.items())
    for conv_b, attn_b in ab.VARIANTS.values():
        got = ab.make_variant_policy(cfg, conv_b, attn_b)
        want = jab.make_variant_policy(chain["jcfg"], conv_b, attn_b)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {k: dataclasses.asdict(v)
                                                                      for k, v in want.items()}
    assert dataclasses.asdict(ab.AblationConfig()) == dataclasses.asdict(jab.AblationConfig())


@pytest.mark.parametrize("variant", list(ab.VARIANTS))
def test_variant_qstates_match_jax(chain, variant):
    """On the trajectory JAX's run calibrated the variant on: every conv at
    every step, given the input JAX's calibration forward gave it, gets
    JAX's update under the variant's policy (5e-7; the logits exact), and
    the port's whole `calibrate_variant` gives JAX's states at the first
    conv, whose input is the same on both sides (1e-6).  Later convs differ
    by the chained codes (ROADMAP Queue 3)."""
    conv_b, attn_b = ab.VARIANTS[variant]
    xs_in, seq, want = chain["calls"][variant]
    np.testing.assert_array_equal(xs_in[0], chain["x_cal"])  # the recorded call is this run's calibration
    jq = JQuantizedUNet(cfg=chain["jcfg"], policy=jab.make_variant_policy(chain["jcfg"], conv_b, attn_b))
    jst0 = jq.init_state(STEPS)
    one_conv = jax.jit(j_calibrate_one_conv, static_argnums=(2, 3, 4))
    records = []
    t_rev = np.asarray(seq, np.float32)[::-1]
    for s in range(STEPS):
        def conv_apply(name, xin, p, *, stride=1, padding="SAME", s=s):
            upd, xq = one_conv(xin, jst0[name], jq.policy[name], s, True)
            records.append((s, name, np.asarray(xin), {k: np.asarray(v) for k, v in upd.items()}))
            return j_conv2d(xq, p, stride=stride, padding=padding)

        j_unet_apply(chain["np_params"], chain["jcfg"], xs_in[s], jnp.full((CALIB,), t_rev[s]), conv_apply=conv_apply)

    cfg = UNetConfig.from_config(chain["config"])
    params = from_jax_params(chain["np_params"], device="cpu")
    qunet, got = ab.calibrate_variant(cfg, params, conv_b, attn_b, torch.tensor(xs_in), seq, "cpu")
    assert qunet.policy == ab.make_variant_policy(cfg, conv_b, attn_b)
    assert set(got) == set(want) and len(records) == STEPS * len(got)
    st0 = qunet.init_state(STEPS, "cpu")
    for s, name, xin, upd in records:
        mine, _ = _calibrate_one_conv(torch.tensor(xin), st0[name], qunet.policy[name], s, True)
        for f in FIELDS:
            np.testing.assert_allclose(mine[f].numpy(), upd[f], rtol=0 if f == "alpha_logits" else 5e-7,
                                       err_msg=f"{variant} step {s} {name}.{f}")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got["conv_in"], f).numpy(), np.asarray(getattr(want["conv_in"], f)),
                                   rtol=1e-6, err_msg=f"{variant} conv_in.{f}")


def test_fid_rows_match_jax_on_its_draws(chain, tmp_path):
    params = from_jax_params(chain["np_params"], device="cpu")
    got = ab.run_attention_ablation(chain["config"], str(tmp_path), params=params, device="cpu",
                                    ablation_cfg=ab.AblationConfig(**chain["acfg"]),
                                    clip_scorer=lambda imgs: float(np.asarray(imgs).mean()),
                                    x_init={k: torch.tensor(v) for k, v in chain["x_init"].items()},
                                    x_cal=torch.tensor(chain["x_cal"]))
    want = chain["rows"]
    assert list(got) == list(want)
    for v in want:
        assert set(got[v]) == set(want[v]) | {"clip_score"} == {"conv_bits", "attention_bits", "fid_vs_fp", "seconds",
                                                                 "clip_score"}
        assert (got[v]["conv_bits"], got[v]["attention_bits"]) == (want[v]["conv_bits"], want[v]["attention_bits"])
        rel = abs(got[v]["fid_vs_fp"] - want[v]["fid_vs_fp"]) / want[v]["fid_vs_fp"]
        print(f"{v}: port {got[v]['fid_vs_fp']:.6g} JAX {want[v]['fid_vs_fp']:.6g} rel {rel:.3e}")
        pix = np.mean([np.abs(read_png(str(tmp_path / v / f"{j}.png")).astype(int)
                              - read_png(str(chain["out"] / v / f"{j}.png")).astype(int)).mean() for j in range(16)])
        print(f"   {v} mean abs pixel diff {pix:.3f}")
        assert pix < PIXEL_DIFF[v], (v, pix)
    for v in want:
        rel = abs(got[v]["fid_vs_fp"] - want[v]["fid_vs_fp"]) / want[v]["fid_vs_fp"]
        assert rel < FID_REL, (v, got[v], want[v])
        assert len(list((tmp_path / v).glob("*.png"))) == min(16, SAMPLES)
    with open(tmp_path / "ablation_results.yaml") as f:
        assert yaml.safe_load(f) == got


def test_cli_runs_ddpm(tmp_path):
    (tmp_path / "toy.yml").write_text(yaml.safe_dump(_toy()))
    assert ab.main(["--config", str(tmp_path / "toy.yml"), "--out", str(tmp_path / "o"), "--steps", "1",
                    "--num-samples", "2", "--batch", "2", "--sampler", "ddpm", "--device", "cpu"]) == 0
    with open(tmp_path / "o" / "ablation_results.yaml") as f:
        rows = yaml.safe_load(f)
    assert list(rows) == list(ab.VARIANTS)
    assert all(np.isfinite(r["fid_vs_fp"]) and "clip_score" not in r for r in rows.values())
