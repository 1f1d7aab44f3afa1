"""PyTorch port vs the JAX package: the quality ladder
(`tools/quality_protocol.run_protocol`), its fp32, bf16 and stage-1 rows
here, its stage-2 rows in tests/test_torch_quality_stage2.py and its
serving rows in tests/test_torch_quality_serving.py (one JAX ladder a
file: each compiles for about a minute).

Both ladders run on tests/test_quality_protocol.py's toy (`CFG`: ch 64,
16^2, attention at 8^2) from JAX's seeded weights, 4 quad steps, batch 2,
calibration batch 2, with JAX's draws handed to the port: x_T and the
calibration batch (`split(PRNGKey(0))`) and each stage-2 run's noise
(`fold_in(fold_in(key, 7 | 8), step)`).  Measured on this toy, the port's
rows lie from JAX's by at most 14% on `eps_rel_mse_max`, 10% on
`eps_rel_mse_mean` (the bf16 row; JAX's own rows move 4% between CPU
thread counts) and 2.0 dB of PSNR: whole fake-quant forwards differ by
float-order code flips.  The bands below, 25% and 3 dB, fail when
two bit configs' rows are swapped (W8A8 and W4A8 lie 8x and 6 dB apart).
The fp32 row is exactly 0, and the rows ordered by `eps_rel_mse_mean` come
in JAX's order."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init

_SAVED = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
from attentiondm_tpu.tools import quality_protocol as jqp  # noqa: E402  (it points JAX's compile cache at /tmp)

jax.config.update("jax_compilation_cache_dir", _SAVED[0])  # keep JAX's cache where the test run has it
jax.config.update("jax_persistent_cache_min_compile_time_secs", _SAVED[1])

from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params  # noqa: E402
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet  # noqa: E402
from attentiondm_tpu_torch.tools import quality_protocol as qp  # noqa: E402

CFG = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)
STEPS, BATCH, CALIB = 4, 2, 2
BITS = ((8, 8), (4, 8))
EPS_BAND = 0.25  # |port / JAX - 1| of eps_rel_mse_mean and _max
PSNR_BAND = 3.0  # dB


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(batch, calib, steps, shape, tags=(7, 8), epochs=1):
    """JAX's protocol draws: x_init, x_cal and each stage-2 run's noise [epochs, S, calib, ...]."""
    key = jax.random.PRNGKey(0)
    k_eval, k_cal = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(k_eval, (batch,) + shape))
    x_cal = np.asarray(jax.random.normal(k_cal, (calib,) + shape))
    noise = {}
    for tag in tags:
        k = jax.random.fold_in(key, tag)
        noise[tag] = np.stack([np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, ep * steps + i),
                                                                      (calib,) + shape, jnp.float32))
                                         for i in range(steps)]) for ep in range(epochs)])
    return x_init, x_cal, noise


def both_ladders(**kw):
    """(the port's rows, JAX's rows) of `run_protocol(**kw)` on the same weights and draws."""
    jparams = j_unet_init(jax.random.PRNGKey(0), JConfig(**CFG))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    x_init, x_cal, noise = jax_draws(BATCH, CALIB, STEPS, (16, 16, 3))
    kw = dict(steps=STEPS, batch=BATCH, calib_batch=CALIB, **kw)
    ours = qp.run_protocol(params, UNetConfig(**CFG), x_init=torch.tensor(x_init), x_cal=torch.tensor(x_cal),
                           stage2_noise=noise, device="cpu", **kw)
    return ours, jqp.run_protocol(jparams, JConfig(**CFG), **kw)


@pytest.fixture(scope="module")
def ladders():
    return both_ladders(bit_configs=BITS, stage2=False, serving=False, bf16=True)


def off_band(ours, theirs):
    """The names of the rows outside the bands."""
    bad = []
    for name, want in theirs.items():
        got = ours[name]
        if name == "fp32":
            continue
        eps_off = max(abs(got[k] / want[k] - 1) for k in ("eps_rel_mse_mean", "eps_rel_mse_max"))
        if eps_off > EPS_BAND or abs(got["psnr"] - want["psnr"]) > PSNR_BAND:
            bad.append(name)
    return bad


def same_order(ours, theirs):
    """The rows by eps_rel_mse_mean come in JAX's order, up to neighbours JAX
    itself puts within the band of each other (a stage-2 row lies about 1%
    from its stage-1 row, a bf16-residual row from its f32 one)."""
    def order(rows):
        return sorted(rows, key=lambda n: rows[n]["eps_rel_mse_mean"])

    for a, b in zip(order(ours), order(theirs)):
        if a != b and abs(theirs[a]["eps_rel_mse_mean"] / theirs[b]["eps_rel_mse_mean"] - 1) >= EPS_BAND:
            return False
    return True


def test_rows_match_jax_within_band(ladders):
    ours, theirs = ladders
    assert list(ours) == list(theirs) == ["fp32", "bf16", "w8a8_s1", "w4a8_s1"]
    assert not off_band(ours, theirs), (qp.format_table(ours), qp.format_table(theirs))
    for row in ours.values():
        assert all(np.isfinite(v) for k, v in row.items() if k != "psnr")


def test_fp32_row_is_exactly_zero(ladders):
    ours, _ = ladders
    assert ours["fp32"] == dict(eps_rel_mse_mean=0.0, eps_rel_mse_max=0.0, psnr=float("inf"))


def test_band_catches_swapped_bit_configs(ladders):
    """The bands are tight enough to see W8A8's and W4A8's rows swapped."""
    ours, theirs = ladders
    swapped = dict(ours, w8a8_s1=ours["w4a8_s1"], w4a8_s1=ours["w8a8_s1"])
    assert set(off_band(swapped, theirs)) == {"w8a8_s1", "w4a8_s1"}


def test_rows_come_in_jaxs_order(ladders):
    """By eps_rel_mse_mean the rows fall in JAX's order (fp32, bf16, W8A8, W4A8)."""
    ours, theirs = ladders
    assert same_order(ours, theirs) and list(theirs) == sorted(theirs, key=lambda n: theirs[n]["eps_rel_mse_mean"])


def test_kid_proxy_equals_jax():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-19):
        a, b = rng.normal(size=(24, 64)) * scale, (rng.normal(size=(20, 64)) + 3.0) * scale
        got, want = qp.kid_proxy(a, b), jqp.kid_proxy(a, b)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
        assert qp.kid_proxy(b, a) > 10 * abs(qp.kid_proxy(rng.normal(size=(24, 64)) * scale, a * 1.0))


def test_metrics_and_table_equal_jax():
    """psnr, rel_eps_mse and format_table against JAX's on the same arrays."""
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(4, 8, 8, 3)).astype(np.float32), rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    assert abs(qp.psnr(torch.from_numpy(a), torch.from_numpy(b)) - jqp.psnr(jnp.asarray(a), jnp.asarray(b))) < 1e-4
    assert qp.psnr(torch.from_numpy(a), torch.from_numpy(a)) == float("inf")
    e, r = rng.normal(size=(3, 2, 4, 4, 3)).astype(np.float32), rng.normal(size=(3, 2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(qp.rel_eps_mse(torch.from_numpy(e), torch.from_numpy(r)).numpy(),
                               np.asarray(jqp.rel_eps_mse(jnp.asarray(e), jnp.asarray(r))), rtol=1e-6)
    rows = {"fp32": dict(eps_rel_mse_mean=0.0, eps_rel_mse_max=0.0, psnr=float("inf"), kid=0.0),
            "w4a8_s1": dict(eps_rel_mse_mean=0.0123, eps_rel_mse_max=0.045, psnr=21.37)}
    assert qp.format_table(rows) == jqp.format_table(rows)


def test_naive_tensorwise_equals_jax():
    """Stage 0's per-tensor ranges on the same weights and trajectory inputs."""
    jparams = j_unet_init(jax.random.PRNGKey(2), JConfig(**CFG))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    xs = np.random.default_rng(3).normal(size=(2, 2, 16, 16, 3)).astype(np.float32)
    seq = [0, 500]
    jq = jqp.QuantizedUNet.create(JConfig(**CFG), bitwidth=4, a_bitwidth=8)
    want = jqp.calibrate_naive_tensorwise(jq, jparams, jq.init_state(2), jnp.asarray(xs), seq)
    q = QuantizedUNet.create(UNetConfig(**CFG), bitwidth=4, a_bitwidth=8)
    got = qp.calibrate_naive_tensorwise(q, params, q.init_state(2, "cpu"), torch.from_numpy(xs), seq)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(got[name].group_ranges.numpy(), np.asarray(want[name].group_ranges), rtol=1e-5,
                                   atol=1e-6)


def test_main_arguments_and_json(tmp_path, capsys):
    """`main` on a toy config YAML on the CPU: --bits, --stage0,
    --attribution, --no_stage2, --no_serving, --json_out; the table printed."""
    cfg = tmp_path / "toy.yml"
    cfg.write_text(yaml.safe_dump({"data": {"image_size": 8, "channels": 3}, "model": {
        "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1], "num_res_blocks": 1, "attn_resolutions": [8],
        "dropout": 0.0, "resamp_with_conv": True}}))
    out = tmp_path / "rows.json"
    rows = qp.main(["--config", str(cfg), "--steps", "2", "--batch", "2", "--calib_batch", "2", "--bits", "8:8",
                    "--stage0", "--attribution", "--no_stage2", "--no_serving", "--json_out", str(out),
                    "--device", "cpu"])
    assert list(rows) == ["fp32", "bf16", "w4only", "w8a8_s0", "w8a8_s1nf", "w8a8_s1", "w16a8_s0", "w16a8_s1nf",
                          "w16a8_s1"]
    saved = json.loads(out.read_text())
    assert saved["weights"] == "random-init" and list(saved["rows"]) == list(rows)
    text = capsys.readouterr().out
    assert "DDIM-2 (quad), batch 2" in text and "| w16a8_s1 |" in text
