"""PyTorch port vs the JAX package: `utils/profiling.py`'s `trace_annotation`,
`utils/metrics_log.py`'s `AverageMeter` and `log_every`, and the native PNG
writer (`native.write_png_batch`, the port's copy of `png_writer.cc` built
with g++): its pixels equal `utils/images.write_png_batch`'s, its bytes JAX's
native writer's."""
import logging
import os

import numpy as np
import pytest
import torch

from attentiondm_tpu.native import write_png_batch as j_write_png_batch
from attentiondm_tpu.utils import metrics_log as jml
from attentiondm_tpu_torch import native
from attentiondm_tpu_torch.utils import images, metrics_log, profiling

def test_trace_annotation_names_a_profiler_region():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace_annotation("adm_region"):
            torch.ones(8).sum()
    assert "adm_region" in {e.key for e in prof.key_averages()}


def test_average_meter_matches_jax():
    ours, theirs = metrics_log.AverageMeter("loss"), jml.AverageMeter("loss")
    for i, v in enumerate([0.5, 1.5, 2.0]):
        ours.update(v, n=i + 1)
        theirs.update(v, n=i + 1)
    assert (ours.val, ours.sum, ours.count, ours.avg) == (theirs.val, theirs.sum, theirs.count, theirs.avg)
    ours.reset()
    assert (ours.val, ours.sum, ours.count, ours.avg) == (0.0, 0.0, 0, 0.0)


@pytest.mark.parametrize("items", [range(5), iter(range(5))], ids=["sized", "iterator"])
def test_log_every_matches_jax(caplog, items):
    import itertools

    a, b = itertools.tee(items) if not hasattr(items, "__len__") else (items, items)
    with caplog.at_level(logging.INFO):
        out = [x * 2 for x in metrics_log.log_every(a, 2, header="t")]
    ours = [r.message for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        jout = [x * 2 for x in jml.log_every(b, 2, header="t")]
    theirs = [r.message for r in caplog.records]
    assert out == jout == [0, 2, 4, 6, 8]
    assert [m.split(" ")[:2] for m in ours] == [m.split(" ")[:2] for m in theirs]
    assert [m.split(" ")[1] for m in ours] == ["[0/5]", "[2/5]", "[4/5]", "total"]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_native_writer_pixels_and_bytes(tmp_path, dtype):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.1, 1.1, (7, 9, 11, 3)).astype(np.float32)
    if dtype == np.uint8:
        x = rng.integers(0, 256, x.shape).astype(np.uint8)
    assert native.native_available()
    assert native.write_png_batch(x, str(tmp_path / "n"), 5, threads=3) == 7
    assert images.write_png_batch(x, str(tmp_path / "p"), 5) == 7
    assert j_write_png_batch(x, str(tmp_path / "j"), 5) == 7
    assert sorted(os.listdir(tmp_path / "n")) == sorted(f"{i}.png" for i in range(5, 12))  # no .tmp left
    for i in range(5, 12):
        got = images.read_png(str(tmp_path / "n" / f"{i}.png"))
        np.testing.assert_array_equal(got, images.read_png(str(tmp_path / "p" / f"{i}.png")))
        with open(tmp_path / "n" / f"{i}.png", "rb") as f, open(tmp_path / "j" / f"{i}.png", "rb") as g:
            assert f.read() == g.read()


def test_native_writer_rejects_non_rgb(tmp_path):
    with pytest.raises(ValueError, match="RGB"):
        native.write_png_batch(np.zeros((2, 4, 4, 1), np.float32), str(tmp_path), 0)


def test_native_build_failure_raises_with_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "png_writer.cc"
    bad.write_text("int write_png_batch( { this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed .*error: "):
        native.write_png_batch(np.zeros((1, 2, 2, 3), np.float32), str(tmp_path / "o"), 0)
    assert not native.native_available()
    assert not list((tmp_path / "build").glob("*.so"))


def test_fid_loop_writes_through_the_native_writer():
    from attentiondm_tpu_torch.runners import diffusion

    assert diffusion.write_png_batch is native.write_png_batch
