"""PyTorch port vs the JAX package: the range analysis of
`tools/activation_range.py` on toys of both attention variants (the
enhanced one's gamma set to 1), on JAX's seeded weights and inputs.

Weight ranges are exact (the same numpy on the same float32 kernels); each
conv input's min / max, and each attention site's (the enhanced variant's
logits included), within 1e-5 relative of the site's range (max - min,
per timestep); mean and std within 1e-5 of the same scale.  The report
files and the cross-model summary are JAX's."""
import json

import jax
import numpy as np
import pytest
import torch

from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.tools import activation_range as jar
from attentiondm_tpu_torch.models.unet import UNetConfig, from_jax_params
from attentiondm_tpu_torch.tools import activation_range as ar

TOYS = {"ddim": dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0),
        "enhanced": dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0,
                         attn_variant="enhanced")}
TS = [0, 400, 999]
REL = 1e-5


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


@pytest.fixture(scope="module", params=list(TOYS))
def both(request):
    jcfg = JConfig(**TOYS[request.param])
    np_params = _gamma(jax.tree_util.tree_map(np.asarray, j_unet_init(jax.random.PRNGKey(0), jcfg)), 1.0)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 3)).astype(np.float32)
    return dict(variant=request.param, jcfg=jcfg, cfg=UNetConfig(**TOYS[request.param]), np_params=np_params,
                params=from_jax_params(np_params, device="cpu"), x=x)


def _held(got, want, stats):
    assert list(got) == list(want)
    for name in want:
        scale = np.maximum(np.asarray(want[name]["max"]) - np.asarray(want[name]["min"]), 1e-6)
        for s in stats:
            g, w = got[name][s], np.asarray(want[name][s])
            assert isinstance(g, np.ndarray) and g.shape == (len(TS),)
            assert (np.abs(g - w) <= REL * scale).all(), (name, s, g, w)


def test_weight_ranges_exact(both):
    got = ar.collect_weight_ranges(both["params"], both["cfg"])
    want = jar.collect_weight_ranges(both["np_params"], both["jcfg"])
    assert got == want


def test_activation_ranges_match_jax(both):
    got = ar.collect_activation_ranges(both["params"], both["cfg"], torch.tensor(both["x"]), TS)
    want = jar.collect_activation_ranges(both["np_params"], both["jcfg"], both["x"], TS)
    _held(got, want, ("min", "max", "mean", "std"))


def test_attention_ranges_match_jax(both, tmp_path):
    got = ar.collect_attention_ranges(both["params"], both["cfg"], torch.tensor(both["x"]), TS)
    want = jar.collect_attention_ranges(both["np_params"], both["jcfg"], both["x"], TS)
    _held(got, want, ("min", "max"))
    if both["variant"] == "enhanced":
        assert {k for k in got if k.endswith(".logits")} == {"down.0.attn.0.logits", "mid.attn_1.logits",
                                                             "up.0.attn.0.logits", "up.0.attn.1.logits"}
    ar.save_range_report(got, str(tmp_path / "t" / "attention_ranges.json"))
    jar.save_range_report(want, str(tmp_path / "j" / "attention_ranges.json"))
    with open(tmp_path / "t" / "attention_ranges.json") as f, open(tmp_path / "j" / "attention_ranges.json") as g:
        ours, theirs = json.load(f), json.load(g)
    assert list(ours) == list(theirs) and all(list(ours[k]) == list(theirs[k]) for k in ours)


def test_cross_model_comparison_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    reports = {m: {f"{blk}.{leaf}": {"min": -rng.random(3), "max": rng.random(3)}
                   for blk in ("mid.attn_1", "up.0.attn.0") for leaf in ("q", "proj_out")} for m in ("a", "b")}
    reports["c"] = {"mid.attn_1.output_conv": {"min": np.zeros(3), "max": np.arange(3.0)}}
    got = ar.cross_model_comparison(reports, [0, 500, 999], str(tmp_path / "t"))
    want = jar.cross_model_comparison(reports, [0, 500, 999], str(tmp_path / "j"))
    assert got == want
    for f in ("cross_model_comparison.json", "model_comparison_output_ranges.png", "timestep_pattern_comparison.png"):
        assert (tmp_path / "t" / f).is_file()


def test_cli_writes_the_reports_and_plots(tmp_path):
    import yaml

    from attentiondm_tpu_torch.config import load_config, namespace2dict

    d = namespace2dict(load_config("cifar10.yml"))
    d["data"]["image_size"] = 8
    d["model"].update(ch=64, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8])
    (tmp_path / "toy.yml").write_text(yaml.safe_dump(d))
    out = tmp_path / "out"
    assert ar.main(["--config", str(tmp_path / "toy.yml"), "--out", str(out), "--timesteps", "0,999", "--batch", "2",
                    "--enhanced", "--device", "cpu"]) == 0
    for f in ("activation_ranges", "weight_ranges", "attention_ranges"):
        assert (out / f"{f}.json").is_file()
    for f in ("activation_ranges", "weight_ranges", "attention_heatmap"):
        assert (out / f"{f}.png").is_file()
    with open(out / "attention_ranges.json") as f:
        assert any(k.endswith(".logits") for k in json.load(f))
    assert ar.main(["--compare", f"{tmp_path / 'toy.yml'},{tmp_path / 'toy.yml'}", "--out", str(tmp_path / "cmp"),
                    "--timesteps", "0,999", "--batch", "1", "--device", "cpu"]) == 0
    with open(tmp_path / "cmp" / "cross_model_comparison.json") as f:
        assert list(json.load(f)["avg_output_ranges"]) == ["toy"]
