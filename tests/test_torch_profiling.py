"""PyTorch port vs the JAX package: `utils/profiling.py` (`trace_annotation`,
`StepTimer`, `SmoothedValue` with its cross-process sum over a gloo group),
`utils/metrics_log.py`'s `AverageMeter` and `log_every`, and the native PNG
writer (`native.write_png_batch`, the port's copy of `png_writer.cc` built
with g++): its pixels equal `utils/images.write_png_batch`'s, its bytes JAX's
native writer's."""
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from attentiondm_tpu.native import write_png_batch as j_write_png_batch
from attentiondm_tpu.utils import metrics_log as jml
from attentiondm_tpu.utils import profiling as jprof
from attentiondm_tpu_torch import native
from attentiondm_tpu_torch.utils import images, metrics_log, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoothed_value_matches_jax():
    vals = [1.0, 2.5, -3.0, 4.0, 7.25, 0.5]
    ours, theirs = profiling.SmoothedValue(window_size=4), jprof.SmoothedValue(window_size=4)
    for i, v in enumerate(vals):
        ours.update(v, n=i % 3 + 1)
        theirs.update(v, n=i % 3 + 1)
        assert (ours.median, ours.avg, ours.global_avg) == (theirs.median, theirs.avg, theirs.global_avg)
    assert list(ours.deque) == list(theirs.deque) == vals[-4:]
    ours.synchronize_between_processes()  # one process, no group: nothing changes
    assert (ours.count, ours.total) == (theirs.count, theirs.total)
    empty = profiling.SmoothedValue()
    assert np.isnan(empty.median) and np.isnan(empty.avg) and empty.global_avg == 0.0


def test_smoothed_value_sums_across_a_gloo_group(tmp_path):
    """Two processes in a gloo group: each one's (count, total) becomes the
    sum of both; the windows stay each process's own."""
    code = textwrap.dedent("""
        import sys, torch.distributed as dist
        from attentiondm_tpu_torch.utils.profiling import SmoothedValue
        rank = int(sys.argv[1])
        dist.init_process_group("gloo", init_method="file://" + sys.argv[2], rank=rank, world_size=2)
        s = SmoothedValue(window_size=2)
        for v in ([1.0, 2.0, 3.0] if rank == 0 else [10.0]):
            s.update(v)
        s.synchronize_between_processes()
        print(s.count, s.total, s.avg)
        dist.destroy_process_group()
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path / "rdv")], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert [o.split() for o, _ in outs] == [["4", "16.0", "2.5"], ["4", "16.0", "10.0"]]


def test_step_timer():
    t = profiling.StepTimer()
    with t.lap():
        pass
    out = []
    with t.lap(out):
        out.append({"x": [torch.ones(3) * 2]})
    assert len(t.times) == 2 and t.best >= 0 and t.mean >= t.best
    assert np.isnan(profiling.StepTimer().best) and np.isnan(profiling.StepTimer().mean)


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
