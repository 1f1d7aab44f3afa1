"""Fixtures of the benchmark's own tests: a copy of the benchmark with a toy
cell added by files alone, and the card for the tests marked `gpu`."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TOY_CELL = "toy-w4a8-b4-ddim3"


def write_json(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")


def add_toy(root: Path):
    """A toy configuration (the CIFAR-10 config at 16², one level of 128 and
    one of 256 channels, one resblock a level, attention at 8²), a 4-image
    DDIM-3 mix and their cell, added to the copy at `root` by new files and
    new BENCHMARK.json entries only."""
    cfg = json.loads((root / "portbench/configs/ddpm-cifar10.json").read_text())
    cfg["data"]["image_size"] = 16
    cfg["model"].update(ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8])
    write_json(root / "portbench/configs/toy.json", cfg)
    mix = json.loads((root / "portbench/traffic/closed-b256-ddim10-quad.json").read_text())
    mix.update(batch=4, timesteps=3, trace_calls=1)
    write_json(root / "portbench/traffic/toy-mix.json", mix)
    write_json(root / f"portbench/workloads/{TOY_CELL}.json",
               {"teacher_gap": 1e-4, "fold_gap": 1e-4, "block_gap": 8e-4, "block_median": 1e-4, "image_gap": 0.05})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": TOY_CELL, "config": "toy", "traffic": "toy-mix", "chips": 1, "why": "toy"})
    bench["configs"].append({"name": "toy", "source": "test", "file": "portbench/configs/toy.json", "reduced": [],
                             "why": "toy"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2) + "\n")
    return TOY_CELL


@pytest.fixture
def bench_copy(tmp_path):
    """BENCHMARK.json and portbench/ copied alone into a temporary checkout."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


@pytest.fixture
def toy(bench_copy):
    torch.set_num_threads(2)
    return bench_copy, add_toy(bench_copy)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
