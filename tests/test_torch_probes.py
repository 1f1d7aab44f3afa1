"""The seven Hopper probes (`attentiondm_tpu_torch/tools/`: conv_roofline,
conv_attack_probe, perf_probe_int8, step_breakdown, ab_serving_levers,
bench_enhanced_mp, gptq_imagenet64_probe) on the CPU: each one's arguments
and JSON record at a toy setting (the plain versions run once, every time
null: a CPU run measures no device), and their numeric parts against JAX's
where JAX has them: `conv_roofline.conv_shape_table` equals JAX's at
CIFAR-10's config, the census equals JAX's `CENSUS`, the lever variants
equal JAX's dictionary, and the GPTQ probe's round-to-nearest and GPTQ
quadratic errors on a toy equal JAX's given JAX's trajectory and states.

JAX's tool modules point JAX's compilation cache at a fixed directory when
they are imported; `_jax_tool` imports them with that setting restored.
"""
import contextlib
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from attentiondm_tpu_torch.config import load_config, namespace2dict
from attentiondm_tpu_torch.models.unet import UNetConfig
from attentiondm_tpu_torch.tools import (ab_serving_levers, bench_enhanced_mp, conv_attack_probe, conv_roofline,
                                         gptq_imagenet64_probe, perf_probe_int8, step_breakdown)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _cache_kept():
    saved = jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def _jax_tool(name):
    with _cache_kept():
        return importlib.import_module(f"attentiondm_tpu.tools.{name}")


def _record(capsys, rec, out):
    """The printed last line and the --out file are the returned record."""
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(rec)) == json.loads(out.read_text())
    assert rec["card"] == {"name": "cpu", "nvidia_smi": None} and rec["device"] == "cpu"


@pytest.mark.parametrize("batch", [128, 4])
def test_conv_shape_table_equals_jax(batch):
    from attentiondm_tpu.models import UNetConfig as JConfig

    jcr = _jax_tool("conv_roofline")
    assert conv_roofline.conv_shape_table(UNetConfig(), batch) == jcr.conv_shape_table(JConfig(), batch)


def test_conv_roofline_cli_and_lowerings(tmp_path, capsys):
    """Every distinct shape once, with its count, bound and three lowerings,
    im2col and shift-and-add equal to K1's int32 mode; times null."""
    out = tmp_path / "cr.json"
    rec = conv_roofline.main(["--batch", "1", "--reps", "1", "--device", "cpu", "--out", str(out)])
    _record(capsys, rec, out)
    table = conv_roofline.conv_shape_table(UNetConfig(), 1)
    assert sum(r["count"] for r in rec["rows"]) == len(table)
    assert len(rec["rows"]) == len({(s["variant"], s["res"], s["Cp"], s["Np"], s["k"]) for s in table})
    for r in rec["rows"]:
        assert r["im2col_equal"] and r["shifted_equal"] and r["k1_ms"] is None and r["bound_ms"] > 0
    assert rec["step_totals_ms"] == {"k1": None, "im2col": None, "shifted": None}
    with pytest.raises(SystemExit):
        conv_roofline.main(["--variants", "xla", "--device", "cpu"])


def test_conv_attack_census_equals_jax_and_cli(tmp_path, capsys):
    jca = _jax_tool("conv_attack_probe")
    out = tmp_path / "ca.json"
    rec = conv_attack_probe.main(["--batch", "1", "--reps", "1", "--device", "cpu", "--out", str(out),
                                  "--parts", "dot,k1,bf16,census"])
    _record(capsys, rec, out)
    assert sorted((r["res"], r["Cp"], r["Np"], r["count"]) for r in rec["census"]) == sorted(jca.CENSUS)
    assert all(r["equal"] and r["k1_wins"] is None for r in rec["census"])
    assert [r["M"] for r in rec["dot"]] == [256, 1024, 2048, 256] and len(rec["k1"]) == 4 and len(rec["bf16"]) == 1
    assert "batch" not in rec


def test_perf_probe_int8_cli(tmp_path, capsys):
    out = tmp_path / "pp.json"
    rec = perf_probe_int8.main(["--batch", "2", "--res", "8", "--device", "cpu", "--out", str(out)])
    _record(capsys, rec, out)
    assert rec["shape"] == [2, 8, 8, 128] and len(rec["rows"]) == 11
    assert all(r["ms"] is None and r["bound_ms"] > 0 for r in rec["rows"])


def test_step_breakdown_stubs_and_cli(tmp_path, capsys):
    """Each stub changes the sampler's output (the plain epilogue only on the
    card, where the serving route is the kernel), and restores the module."""
    from attentiondm_tpu_torch.quant import int8_serving as srv

    saved = srv._attn_fused, srv._entry_gn_quant, srv.epilogue_gn_swish_quant
    cfg = UNetConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1)  # wide enough for the fused resblocks
    runs = step_breakdown.build(cfg, 1, torch.device("cpu"))
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    outs = {v: run(x) for v, run in runs.items()}
    for v in ("attn=identity", "entry=quantize-only", "unet=identity"):
        assert not torch.equal(outs[v], outs["full"]), v
    assert torch.equal(outs["epilogue=plain"], outs["full"])
    assert (srv._attn_fused, srv._entry_gn_quant, srv.epilogue_gn_swish_quant) == saved
    out = tmp_path / "sb.json"
    rec = step_breakdown.main(["--batch", "1", "--steps", "1", "--ch", "32", "--device", "cpu", "--out", str(out)])
    _record(capsys, rec, out)
    assert [r["variant"] for r in rec["rows"]] == list(step_breakdown.VARIANTS)
    assert all(r["finite"] and r["ms"] is None for r in rec["rows"])


def test_lever_variants_equal_jax_and_cli(tmp_path, capsys):
    jab = _jax_tool("ab_serving_levers")
    assert list(ab_serving_levers.VARIANTS.items()) == list(jab.VARIANTS.items())
    out = tmp_path / "ab.json"
    rec = ab_serving_levers.main(["--variants", "bf,rb_all,cp16,no_dot_bf16", "--batch", "1", "--steps", "1",
                                  "--ch", "32", "--reps", "1", "--device", "cpu", "--out", str(out)])
    _record(capsys, rec, out)
    assert [r["variant"] for r in rec["rows"]] == ["base", "bf", "cp16", "rb_all", "no_dot_bf16"]
    assert rec["rows"][0]["mean_rel_vs_base"] == 0.0 and all(r["mean_rel_vs_base"] < 0.05 for r in rec["rows"])
    assert rec["rows"][2]["flags"] == {"conv_pallas": [[16, 256, 256]]}
    with pytest.raises(SystemExit):
        ab_serving_levers.main(["--variants", "nope", "--device", "cpu"])


def test_bench_enhanced_mp_cli(tmp_path, capsys):
    out = tmp_path / "be.json"
    rec = bench_enhanced_mp.main(["--batch", "1", "--steps", "1", "--ch", "32", "--reps", "1", "--device", "cpu",
                                  "--out", str(out)])
    _record(capsys, rec, out)
    assert list(rec["finite"]) == ["ddim (headline)", "enhanced", "enhanced+MP"] and all(rec["finite"].values())
    assert rec["enhanced_vs_ddim"] is None and rec["img_per_s"]["enhanced+MP"] is None


def _toy64(tmp_path):
    d = namespace2dict(load_config("imagenet64.yml"))
    d["data"]["image_size"] = 8
    d["model"].update(ch=32, ch_mult=[1], num_res_blocks=1, attn_resolutions=[])
    path = tmp_path / "toy64.yml"
    path.write_text(yaml.safe_dump(d))
    return path


def test_gptq_probe_errors_match_jax(tmp_path):
    """On imagenet64.yml cut to ch 32, one level, 8x8 (its largest K 576): JAX's
    trajectory, stage-1 states and GPTQ pass, and the quadratic errors as
    JAX's probe computes them, against the port's `weight_report` given
    JAX's trajectory and states: the same layer, RTN's error within 1e-5 and
    GPTQ's within 2% (GPTQ's Cholesky solves round differently)."""
    from attentiondm_tpu.config import load_config as j_load_config
    from attentiondm_tpu.diffusion import DiffusionSchedule, ddim_sample, make_timestep_seq
    from attentiondm_tpu.models import UNetConfig as JConfig
    from attentiondm_tpu.models import unet_apply as j_unet_apply
    from attentiondm_tpu.models import unet_init as j_unet_init
    from attentiondm_tpu.ops.quant_conv import weight_grid as j_weight_grid
    from attentiondm_tpu.quant import QuantizedUNet as JQ
    from attentiondm_tpu.quant import calibrate_ranges as j_calibrate
    from attentiondm_tpu.quant.adaround import collect_conv_stats as j_stats
    from attentiondm_tpu.quant.adaround import compute_weight_extras as j_extras
    from attentiondm_tpu.quant.state import mixed_ranges as j_mixed
    from attentiondm_tpu_torch.models.unet import from_jax_params
    from attentiondm_tpu_torch.quant.qunet import QuantizedUNet
    from attentiondm_tpu_torch.quant.state import from_jax_qstates

    steps, path = 2, _toy64(tmp_path)
    jcfg = JConfig.from_config(j_load_config(str(path)))
    params = j_unet_init(jax.random.PRNGKey(0), jcfg)
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000).betas
    seq = make_timestep_seq(1000, steps, "quad")
    x0 = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 8, 3))
    _, traj, _ = ddim_sample(lambda xt, t, i: j_unet_apply(params, jcfg, xt, t), x0, seq, betas,
                             keep_trajectory=True)
    xs = jnp.concatenate([x0[None], traj[:-1]], axis=0)
    jq = JQ.create(jcfg, bitwidth=4, a_bitwidth=8)
    jst = j_calibrate(jq, params, jq.init_state(steps), xs, seq, first=True)
    jex = j_extras(jq, params, jst, xs, seq, max_steps=steps, method="gptq")
    name = "up.0.block.0.conv1"  # K = 9 x (32 + 32), the first of the toy's two largest
    stats = j_stats(params, jcfg, xs, seq, max_steps=steps, names=[name], k_cap=576)[name]
    kernel = params["up"][0]["block"][0]["conv1"]["kernel"]
    kh, kw, ci, co = kernel.shape
    scale = jax.vmap(lambda s: 255 / (lambda r: r[1] - r[0])(j_mixed(jst[name], s)))(jnp.arange(steps)).mean(axis=0)
    g = (kernel / scale.reshape(1, 1, ci, 1)).reshape(kh * kw * ci, co)
    ws, wzp = j_weight_grid(g, 4, True, jnp.broadcast_to(jex[name].shrink, (co,)))
    H = stats.gram / jnp.maximum(stats.count, 1.0)
    base = ws[None] * g - wzp[None]

    def quad(q):
        d = (q + wzp[None]) / ws[None] - g
        return float(jnp.sum(d * (H @ d)))

    want_rtn = quad(jnp.clip(jnp.round(base), -8, 7))
    want_gptq = quad(jnp.clip(jnp.floor(base) + jex[name].round_offset.reshape(-1, co), -8, 7))

    cfg = UNetConfig.from_config(load_config(str(path)))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    qunet = QuantizedUNet.create(cfg, bitwidth=4, a_bitwidth=8)
    qstates = from_jax_qstates({n: {k: np.asarray(getattr(v, k)) for k in v.__dataclass_fields__}
                                for n, v in jst.items()}, device="cpu")
    _, rep = gptq_imagenet64_probe.weight_report(cfg, tparams, qunet, qstates, torch.tensor(np.asarray(xs)),
                                                 seq, steps)
    assert rep["largest_layer"] == name and rep["k_top"] == 576 and not rep["advisories"]
    assert rep["k_top_with_offsets"] == rep["k_top_layers"] == 2  # up.0.block.0 and .1
    assert rep["quad_err_rtn"] == pytest.approx(want_rtn, rel=1e-5)
    assert rep["quad_err_gptq"] == pytest.approx(want_gptq, rel=2e-2)
    assert rep["gptq_vs_rtn"] < 1.0


def test_gptq_probe_cli(tmp_path, capsys):
    out = tmp_path / "gp.json"
    rec = gptq_imagenet64_probe.main(["--config", str(_toy64(tmp_path)), "--device", "cpu", "--out", str(out)])
    _record(capsys, rec, out)
    assert rec["advisories"] == [] and rec["gram_k_max"] == 18432 and rec["k_top"] == 576
    assert rec["eps_rel_mse_rtn"] > 0 and rec["eps_rel_mse_gptq"] > 0 and rec["offset_min_max"][0] < 0
