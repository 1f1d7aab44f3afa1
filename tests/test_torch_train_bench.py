"""The port's training bench (`tools/train_bench.py`) on the CPU toy: its
arguments, the per-batch results and the summary JSON, the checkpoint
round trip, and the CUDA device it takes when none is named.  Its times are
the CPU's here; `chip_smoke.py --paths cifar10-quality` runs it on the card
at cifar10.yml's batch 512."""
import json

import numpy as np
import pytest
import torch
import yaml

from attentiondm_tpu_torch.checkpoint import read_flat
from attentiondm_tpu_torch.config import load_config, namespace2dict
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, tree_leaves
from attentiondm_tpu_torch.tools import train_bench
from test_runner import tiny_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def toy_yml(tmp_path):
    """tests/test_runner.py's tiny config (Adam, clip 1.0, EMA 0.999) at 8x8 with dropout 0.1."""
    d = namespace2dict(tiny_config(None))
    d["data"]["image_size"], d["model"]["dropout"] = 8, 0.1
    path = tmp_path / "toy.yml"
    path.write_text(yaml.safe_dump(d))
    return str(path)


def test_main_arguments_and_json(tmp_path, toy_yml, capsys):
    out = tmp_path / "bench.json"
    summary = train_bench.main(["--config", toy_yml, "--batches", "2,4", "--steps", "2", "--json", str(out),
                                "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))
    assert summary["metric"] == "train_img_per_s" and summary["device"] == "cpu"
    assert [r["batch"] for r in summary["results"]] == [2, 4]
    for r in summary["results"]:
        assert r["steps"] == 2 and np.isfinite(r["loss"]) and r["img_per_s"] > 0
        assert r["device_ms"] is None and r["max_memory_gb"] is None  # no device figures from the CPU
    best = max(summary["results"], key=lambda r: r["img_per_s"])
    assert summary["batch"] == best["batch"]
    assert set(summary["checkpoint"]) == {"save_s", "load_s", "size_mb"}
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu (cpu)" and json.loads(lines[-1]) == json.loads(json.dumps(summary))


def test_bench_batch_is_the_configs_train_step(toy_yml, tmp_path):
    """The config's optimizer, clipping and EMA: the EMA moves, the step
    counts, and the checkpoint round trip reads back the same params."""
    config = load_config(toy_yml)
    cfg = UNetConfig.from_config(config)
    betas = DiffusionSchedule.from_config(config, device="cpu").betas
    r, state = train_bench.bench_batch(cfg, betas, config, 2, 2, warmup=1, device="cpu")
    assert int(state.step) == 3 and state.ema is not None and r["steps"] == 2
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(state.ema), tree_leaves(state.params)))
    ck = train_bench.bench_checkpoint(state, str(tmp_path / "s.npz"), device="cpu")
    assert int(read_flat(str(tmp_path / "s.npz"))["step"]) == 3
    want = float(sum(a.abs().float().sum() for a in tree_leaves(state.params)))
    assert ck["param_l1"] == pytest.approx(want, rel=1e-12) and ck["size_mb"] > 0


def test_needs_a_device_or_cpu(toy_yml, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_bench.main(["--config", toy_yml, "--batches", "2", "--steps", "1"])
