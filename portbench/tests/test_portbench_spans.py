"""The readers of the serving call's own spans (`adm.*`) on a hand-made Chrome
trace: ATen kernels found by the leaf span their launch lies in, a port
kernel inside a leaf span left out, the median host step, and nothing read
where the spans are absent (a program without them)."""
import pytest

from portbench.harness.registry import Registry
from portbench.harness.runner import Record
from portbench.harness.trace import TraceView

from .conftest import ROOT

GLUE = {"entry_ms": "adm.entry", "halo_ms": "adm.halo", "quant_io_ms": "adm.quant_io", "exit_ms": "adm.exit"}


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


def events(with_spans=True):
    """One call of two steps.  Step 1 (0 to 100 us): an entry with an ATen
    kernel (4 us) and K4 (port, 20 us), a halo (ATen, 2 us), K1 (port, 30 us),
    a quantize and a dequant (ATen, 3 + 1 us), an exit with an ATen add (5 us)
    and K7 (port, 7 us).  Step 2 (100 to 160 us): an entry (ATen, 6 us) and
    an ATen kernel outside every leaf span (8 us)."""
    ev = [X("user_annotation", "portbench.call", 0, 200),
          X("user_annotation", "portbench.step", 1, 98), X("user_annotation", "portbench.step", 101, 58)]
    if with_spans:
        ev += [X("user_annotation", "adm.sample", 0, 199),
               X("user_annotation", "adm.step", 0, 100), X("user_annotation", "adm.step", 100, 60),
               X("user_annotation", "adm.entry", 2, 10), X("user_annotation", "adm.halo", 13, 5),
               X("user_annotation", "adm.quant_io", 19, 3), X("user_annotation", "adm.quant_io", 30, 3),
               X("user_annotation", "adm.exit", 40, 10), X("user_annotation", "adm.entry", 102, 5)]
    ops = [("aten::native_group_norm", 3, 0, "void at::native::reduce_kernel<512, 1>(R)", 4),
           (None, 8, 0, "void gn_image_kernel<128>(GnArgs)", 20),
           ("aten::copy_", 14, 0, "void at::native::elementwise_kernel<128, 4>(int, F)", 2),
           (None, 25, 0, "void adm::igemm_kernel<3, 1, 128>(Maps, IgArgs)", 30),
           ("aten::clamp", 20, 0, "void at::native::vectorized_elementwise_kernel<4, Clamp>(int, Clamp)", 3),
           ("aten::mul", 31, 0, "void at::native::vectorized_elementwise_kernel<4, Mul>(int, Mul)", 1),
           ("aten::add", 41, 0, "void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)", 5),
           (None, 45, 0, "void adm::k7_kernel<8>(K7Args)", 7),
           ("aten::var_mean", 103, 0, "void at::native::reduce_kernel<512, 1>(R)", 6),
           ("aten::zeros_like", 150, 0, "void at::native::vectorized_elementwise_kernel<4, Fill>(int, Fill)", 8)]
    for corr, (op, ts, _x, kernel, dur) in enumerate(ops, start=1):
        if op is not None:
            ev.append(X("cpu_op", op, ts - 0.5, 1.5))
        ev.append(X("cuda_runtime", "cudaLaunchKernel", ts, 0.5, correlation=corr))
        ev.append(X("kernel", kernel, 200 + 40 * corr, dur, tid=7, correlation=corr))
    return ev


def record(with_spans=True):
    rec = Record()
    rec.trace = TraceView(events(with_spans))
    return rec


@pytest.fixture
def reg():
    return Registry(ROOT)


def test_glue_readers_count_the_aten_kernels_of_their_span(reg):
    rec = record()
    assert rec.trace.steps == 2
    # ms per step: entry (4 + 6) / 2 us, halo 2 / 2, quant_io (3 + 1) / 2, exit 5 / 2
    want = {"entry_ms": 5e-3, "halo_ms": 1e-3, "quant_io_ms": 2e-3, "exit_ms": 2.5e-3}
    assert {m: reg.reader(m)(rec) for m in GLUE} == pytest.approx(want)


def test_a_port_kernel_inside_a_leaf_span_is_not_counted(reg):
    rec = record()
    by = {k.name.split("<")[0].removeprefix("void "): k for k in rec.trace.kernels}
    assert "adm.entry" in by["gn_image_kernel"].spans and not by["gn_image_kernel"].aten
    assert "adm.exit" in by["adm::k7_kernel"].spans and not by["adm::k7_kernel"].aten
    rec_without = record()
    rec_without.trace.kernels = [k for k in rec_without.trace.kernels if k.aten]
    assert reg.reader("entry_ms")(rec) == reg.reader("entry_ms")(rec_without)
    assert reg.reader("exit_ms")(rec) == reg.reader("exit_ms")(rec_without)


def test_host_step_is_the_median_step_range(reg):
    rec = record()
    assert reg.reader("host_step_ms")(rec) == pytest.approx(80e-3)  # the median of 100 and 60 us
    rec.trace.host.append(X("user_annotation", "adm.step", 300, 1000))  # after the traced calls: left out
    assert reg.reader("host_step_ms")(rec) == pytest.approx(80e-3)


@pytest.mark.parametrize("metric", sorted(GLUE) + ["host_step_ms"])
def test_an_absent_span_reads_nothing(reg, metric):
    assert reg.reader(metric)(record(with_spans=False)) is None
    assert reg.reader(metric)(Record()) is None


def test_the_new_metrics_are_entries_of_the_benchmark(reg):
    entries = {m["name"]: m for m in reg.bench["per_layer"]}
    cells = [w["name"] for w in reg.bench["workloads"]]
    for name in sorted(GLUE) + ["host_step_ms"]:
        m = entries[name]
        assert (m["unit"], m["better"], m["moves"]) == ("ms", "lower", "images_per_s")
        assert set(m["workloads"]) <= set(cells)
    assert entries["host_step_ms"]["workloads"] == ["cifar10-w4a8-b256-ddim10"]
