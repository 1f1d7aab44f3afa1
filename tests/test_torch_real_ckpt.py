"""The port's real-checkpoint on-ramp (`tools/real_ckpt.py`):
tests/test_real_ckpt.py's cases on the port, on the CPU.  Asset discovery
and the md5 check; the whole chain (discovery, conversion by name, the
mandatory golden check against tests/torch_oracle.py, sampling, Inception
statistics, the Frechet distance against reference statistics) dry-run on
stand-in assets of the right layout; a missing oracle raises, a golden
mismatch exits nonzero."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from attentiondm_tpu_torch.models import torch_convert
from attentiondm_tpu_torch.tools import real_ckpt
from attentiondm_tpu_torch.tools.real_ckpt import find_real_assets, golden_check, verify_md5
from torch_inception_oracle import TorchFIDInception, randomize_
from torch_oracle import TorchDDIMUNet

TOY_YML = ("data:\n    dataset: CIFAR10\n    image_size: 16\n    channels: 3\n"
           "model:\n    in_channels: 3\n    out_ch: 3\n    ch: 32\n    ch_mult: [1, 2]\n    num_res_blocks: 1\n"
           "    attn_resolutions: [8]\n    dropout: 0.0\n    resamp_with_conv: True\n")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_find_real_assets_discovers_supplied_files(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "model-790000.ckpt").write_bytes(b"fake")
    (tmp_path / "pt_inception-2015-12-05-6726825d.pth").write_bytes(b"fake")
    assets = find_real_assets(extra_dirs=[str(tmp_path)])
    assert assets["cifar10"] and assets["cifar10"].endswith("model-790000.ckpt")
    assert assets["ema_cifar10"] == assets["cifar10"]  # the same file name, the same hit
    assert assets["pt_inception"] and assets["fid_stats"] is None
    assert not verify_md5("cifar10", assets["cifar10"])  # md5 rejects the fake
    assert verify_md5("not_registered", assets["cifar10"])


@pytest.fixture
def assets(tmp_path):
    """A toy config, the oracle's state dict under the registry's file name,
    a randomized pt_inception-layout Inception, reference statistics."""
    (tmp_path / "toy.yml").write_text(TOY_YML)
    torch.manual_seed(0)
    net = TorchDDIMUNet(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16)
    torch.save(net.state_dict(), str(tmp_path / "model-790000.ckpt"))
    torch.save(randomize_(TorchFIDInception(), seed=3).state_dict(),
               str(tmp_path / "pt_inception-2015-12-05-6726825d.pth"))
    a = np.random.default_rng(0).standard_normal((8, 2048))
    np.savez(tmp_path / "fid_stats_cifar10_train.npz", mu=a.mean(0), sigma=np.cov(a, rowvar=False))
    return tmp_path


def _argv(tmp_path, *extra):
    return ["--name", "cifar10", "--dir", str(tmp_path), "--config", str(tmp_path / "toy.yml"), "--steps", "4",
            "--sample_batch", "4", "--out", str(tmp_path / "report.json"), "--grid", str(tmp_path / "grid.png"),
            "--device", "cpu", *extra]


def test_full_chain_dry_run_on_stand_in_assets(assets, capsys):
    rep = real_ckpt.main(_argv(assets, "--fid", "8"))
    assert rep == json.loads((assets / "report.json").read_text())
    assert rep["md5_ok"] is False  # the stand-in is not the published file
    assert rep["golden_max_abs_diff"] is not None and rep["golden_max_abs_diff"] < 5e-4
    assert rep["sampling_finite"] is True and rep["inception_feat_dim"] == 2048
    assert rep["fid_n"] == 8 and np.isfinite(rep["fid"])
    with np.load(str(assets / "report_stats.npz")) as f:
        assert f["mu"].shape == (2048,) and f["sigma"].shape == (2048, 2048)
    assert os.path.exists(assets / "grid.png")
    out = capsys.readouterr().out
    assert "[2/5] converted" in out and "eigenvalue-form Frechet" in out


def test_missing_checkpoint_is_reported_not_fatal(tmp_path, capsys):
    rep = real_ckpt.main(["--name", "ema_lsun_church", "--dir", str(tmp_path), "--out", str(tmp_path / "r.json"),
                          "--device", "cpu"])
    assert "md5_ok" not in rep and "not found" in capsys.readouterr().out
    assert json.loads((tmp_path / "r.json").read_text()) == rep


def test_golden_check_is_mandatory(monkeypatch):
    """An oracle that cannot be imported raises by default; required=False
    (--skip_oracle) makes it a loud skip that returns None."""
    monkeypatch.setitem(sys.modules, "torch_oracle", None)
    with pytest.raises(RuntimeError, match="golden check is mandatory"):
        golden_check("/nonexistent.ckpt", None, None, ema=False, required=True)
    assert golden_check("/nonexistent.ckpt", None, None, ema=False, required=False) is None


def test_golden_mismatch_exits(assets, monkeypatch):
    """A conversion that does not reproduce the oracle's forward stops the chain."""
    convert = torch_convert.load_torch_checkpoint

    def off(*a, **kw):
        p = convert(*a, **kw)
        p["conv_out"]["bias"] = p["conv_out"]["bias"] + 1e-2
        return p

    monkeypatch.setattr(real_ckpt, "load_torch_checkpoint", off)
    with pytest.raises(SystemExit, match="golden check FAILED"):
        real_ckpt.main(_argv(assets))
    assert json.loads((assets / "report.json").read_text())["golden_max_abs_diff"] >= 5e-4


def test_fid_needs_pt_inception(assets):
    os.remove(assets / "pt_inception-2015-12-05-6726825d.pth")
    with pytest.raises(SystemExit, match="requires pt_inception"):
        real_ckpt.main(_argv(assets, "--fid", "4"))


def test_real_checkpoint_chain_runs_where_supplied(tmp_path):
    """With a published checkpoint placed by hand (none is in the
    repository), the chain runs on it; otherwise this skips."""
    real = find_real_assets()
    name = "ema_cifar10" if real.get("ema_cifar10") else "cifar10"
    if real.get(name) is None:
        pytest.skip("no published DDIM checkpoint placed under $ATTENTIONDM_CKPT_ROOT (none is downloaded)")
    rep = real_ckpt.main(["--name", name, "--steps", "10", "--sample_batch", "2", "--device", "cpu",
                          "--out", str(tmp_path / "r.json"), "--grid", str(tmp_path / "g.png")])
    assert rep["golden_max_abs_diff"] < 5e-4 and rep["sampling_finite"]
