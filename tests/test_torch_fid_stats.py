"""`main_torch.py --sample --fid --fid_stats` on the CPU toy (the runner's
`_score_fid`): the `--fid` folder is written first and scored after, with
the seeded random Inception (JAX's warning) or `--inception_weights`.  The
printed `FID: x.xxxx` and the returned score equal the API that JAX's runner
scores with (`sharded_statistics` over the folder + `frechet_smoke_safe`),
lie within FID64_REL of the float64 route (`compute_statistics_of_path`:
features on the host, `np.cov`), and, on the same folder, reference `.npz`
and `--inception_weights` state dict, within JAX_REL of JAX's runner's
`_score_fid`.  The runner is pinned to the CPU here (on the card it takes
the CUDA device; `chip_smoke.py --paths cifar10-quality` runs the same flow
there)."""
import glob
import os
import re

import numpy as np
import pytest
import torch
import yaml

import main_torch
from attentiondm_tpu_torch.config import namespace2dict
from attentiondm_tpu_torch.eval import fid
from attentiondm_tpu_torch.eval.inception import InceptionV3FID
from attentiondm_tpu_torch.runners import diffusion as runner_mod
from attentiondm_tpu_torch.utils.images import write_png_batch
from test_runner import tiny_config
from torch_inception_oracle import TorchFIDInception, randomize_

N = 6  # --num_samples (two --fid batches of 4, the last cut to 2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The tiny config as a YAML file, reference statistics of 8 stand-in
    PNGs (`eval.fid --save-stats`, random Inception), and the runner on the
    CPU; `_score_fid` spied on to count the folder's PNGs when it is called."""
    cfg = tmp_path / "toy.yml"
    cfg.write_text(yaml.safe_dump(namespace2dict(tiny_config(None))))
    ref = str(tmp_path / "ref")
    write_png_batch(np.random.default_rng(0).random((8, 16, 16, 3)), ref, 0)
    stats = str(tmp_path / "ref_stats.npz")
    assert fid.main([ref, stats, "--save-stats", "--device", "cpu"]) == 0
    monkeypatch.setattr(runner_mod, "default_device", lambda: torch.device("cpu"))
    seen = []
    score = runner_mod.Diffusion._score_fid

    def spy(self):
        seen.append(len(glob.glob(os.path.join(self.args.image_folder, "*.png"))))
        return score(self)

    monkeypatch.setattr(runner_mod.Diffusion, "_score_fid", spy)
    return str(cfg), stats, seen


def _run(tmp_path, cfg, stats, *extra):
    argv = ["--config", cfg, "--doc", "f", "--exp", str(tmp_path / "exp"), "--sample", "--ni", "--fp32", "--fid",
            "--num_samples", str(N), "--batch_size", "4", "--timesteps", "3", "--fid_stats", stats,
            "--image_folder", "fid", *extra]
    assert main_torch.main(argv) == 0
    return main_torch.main.runner


# The float32 sums of f and f f^T against float64 statistics: measured 2.5e-6
# relative on the random Inception, 1.0e-7 on the randomized oracle's weights.
FID64_REL = 2e-5
# The port's runner against JAX's on the same files: measured 8.4e-8 relative
# (features within 1e-4 of JAX's, summed in another order).
JAX_REL = 1e-6


def _api(folder, net, stats):
    """The FID as the runner scores it, and by the float64 route."""
    with np.load(stats) as f:
        ref = f["mu"], f["sigma"]
    mu, sigma = fid.sharded_statistics(fid._iter_image_dir(folder, 256), net.extract, device="cpu")
    mu64, sigma64 = fid.compute_statistics_of_path(folder, net.extract, batch_size=256, device="cpu")
    return fid.frechet_smoke_safe(mu, sigma, *ref, N), fid.frechet_smoke_safe(mu64, sigma64, *ref, N)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_fid_stats_scores_the_folder_after_the_run(tmp_path, toy, capsys, caplog):
    cfg, stats, seen = toy
    capsys.readouterr()
    r = _run(tmp_path, cfg, stats)
    printed = re.findall(r"^FID: (\S+)$", capsys.readouterr().out, re.M)
    assert seen == [N] and r.fid_images == N  # called once, on the whole folder
    assert "without --inception_weights" in caplog.text
    api, api64 = _api(r.args.image_folder, InceptionV3FID.random(device="cpu"), stats)
    assert np.isfinite(r.fid_score) and _rel(r.fid_score, api) <= 1e-6
    assert _rel(r.fid_score, api64) <= FID64_REL
    assert printed == [f"{api:.4f}"]
    assert "fid score" in r.timings


def test_fid_stats_with_inception_weights(tmp_path, toy, capsys, caplog):
    """--inception_weights loads a pt_inception-layout state dict (a
    randomized oracle) by name; no warning, the score is that network's and
    JAX's runner scores the same folder with the same files alike."""
    import types

    from attentiondm_tpu.runners.diffusion import Diffusion as JDiffusion

    cfg, stats, seen = toy
    w = str(tmp_path / "pt_inception-2015-12-05-6726825d.pth")
    torch.save(randomize_(TorchFIDInception(), seed=3).state_dict(), w)
    capsys.readouterr()
    r = _run(tmp_path, cfg, stats, "--inception_weights", w)
    printed = re.findall(r"^FID: (\S+)$", capsys.readouterr().out, re.M)
    assert seen == [N] and "without --inception_weights" not in caplog.text
    api, api64 = _api(r.args.image_folder, InceptionV3FID.from_torch(w, device="cpu"), stats)
    assert _rel(r.fid_score, api) <= 1e-6 and _rel(r.fid_score, api64) <= FID64_REL
    assert _rel(r.fid_score, _api(r.args.image_folder, InceptionV3FID.random(device="cpu"), stats)[0]) > 1e-3
    jax_args = types.SimpleNamespace(fid_stats=stats, image_folder=r.args.image_folder, inception_weights=w)
    theirs = JDiffusion._score_fid(types.SimpleNamespace(args=jax_args))
    assert re.findall(r"^FID: (\S+)$", capsys.readouterr().out, re.M) == [f"{theirs:.4f}"]
    assert np.isfinite(theirs) and _rel(r.fid_score, theirs) <= JAX_REL
    assert printed == [f"{r.fid_score:.4f}"]


def test_without_fid_stats_nothing_is_scored(tmp_path, toy):
    cfg, stats, seen = toy
    argv = ["--config", cfg, "--doc", "g", "--exp", str(tmp_path / "exp"), "--sample", "--ni", "--fp32", "--fid",
            "--num_samples", "2", "--batch_size", "2", "--timesteps", "2", "--image_folder", "plain"]
    assert main_torch.main(argv) == 0
    assert seen == [] and main_torch.main.runner.fid_score is None
