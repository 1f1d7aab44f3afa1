"""The trace reader on a hand-made Chrome trace: spans and ATen ops found by
the launching host call, the busy union, the idle gaps and the readers."""
import pytest

from portbench.harness.runner import Record
from portbench.harness.trace import TraceView, short_name
from portbench.roofline.ddpm_unet import Work


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


def events():
    ev = [X("user_annotation", "portbench.call", 0, 100),
          X("user_annotation", "portbench.step", 1, 60), X("user_annotation", "portbench.step", 61, 38),
          X("user_annotation", "portbench.K3", 10, 10),
          X("cpu_op", "aten::add", 30, 5)]
    # launches: a K3 kernel (port), an ATen kernel, a K1 kernel (port), a K2 kernel
    ev += [X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
           X("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
           X("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=3),
           X("cuda_runtime", "cudaLaunchKernelExC", 70, 1, correlation=4)]
    ev += [X("kernel", "void attn_core_kernel<256, false, 64>(AttnCoreArgs)", 20, 10, tid=7, correlation=1),
           X("kernel", "void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)", 35, 5, tid=7,
             correlation=2),
           X("kernel", "void igemm_kernel<3, 1, 128>(Maps, IgArgs)", 50, 20, tid=7, correlation=3),
           X("kernel", "void epi_gn_cluster_kernel<1>(EpiArgs)", 75, 10, tid=7, correlation=4),
           X("gpu_memcpy", "Memcpy DtoH", 90, 5, tid=7)]
    return ev


def test_trace_view_attributes_and_times():
    t = TraceView(events())
    assert (t.calls, t.steps, t.window_s) == (1, 2, pytest.approx(100e-6))
    by = {short_name(k.name): k for k in t.kernels}
    assert set(by) == {"attn_core_kernel", "at::native::vectorized_elementwise_kernel", "igemm_kernel",
                       "epi_gn_cluster_kernel"}
    assert by["attn_core_kernel"].spans == {"portbench.call", "portbench.step", "portbench.K3"}
    assert by["at::native::vectorized_elementwise_kernel"].aten and not by["igemm_kernel"].aten
    assert t.busy_s() == pytest.approx((10 + 5 + 20 + 10 + 5) * 1e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["igemm_kernel", pytest.approx(20e-6)]
    assert b["idle_gaps"][0][1] == pytest.approx(20e-6)  # 0 to 20: nothing on the device yet


def test_readers_on_the_hand_made_trace():
    from portbench.harness.registry import Registry

    from .conftest import ROOT

    reg = Registry(ROOT)
    rec = Record()
    rec.trace = TraceView(events())
    k1, k2, k3 = Work(nbytes=3.35e12 * 2e-6), Work(nbytes=3.35e12 * 1e-6), Work(nbytes=3.35e12 * 5e-6)
    rec.work = {"K1": [k1], "K2": [k2], "K6": [], "K3": [k3], "core": [Work(tf32x3_flops=0.0)]}
    rec.trace.steps = 1  # one step's work, so each kernel above is its only launch
    assert reg.reader("launches_per_step")(rec) == 4
    assert reg.reader("step_device_ms")(rec) == pytest.approx(45e-3)
    assert reg.reader("aten_share")(rec) == pytest.approx(100 * 5 / 45)
    assert reg.reader("conv_roofline")(rec) == pytest.approx(100 * 2 / 20)
    assert reg.reader("gn_roofline")(rec) == pytest.approx(100 * 1 / 10)
    assert reg.reader("attn_roofline")(rec) == pytest.approx(100 * 5 / 10)
    assert reg.reader("device_idle_share")(rec) == pytest.approx(50.0)
    rec.work["K1"] = [k1, k1]  # a launch the trace lacks: the roofline is not read
    assert reg.reader("conv_roofline")(rec) is None
