"""gn_roofline: the resblock GroupNorm epilogues K2 and K6 (ops/fused_gn.py,
csrc/gn_epilogue.cuh): their least time over their device time in the traced
steps.  Nothing is read where the launches found are not the ones the
configuration's shapes give."""
import sys

KERNELS = ("epi_gn_cluster_kernel", "epi_gn_blocked_kernel")


def read(rec):
    t = rec.trace
    if t is None or not t.steps:
        return None
    pick = lambda k: not k.aten and any(n in k.name for n in KERNELS)  # noqa: E731
    work = rec.work["K2"] + rec.work["K6"]
    n, want = t.count(pick), len(work) * t.steps
    if n == 0 or n != want:
        print(f"[portbench] gn_roofline: {n} K2 / K6 launches traced, {want} expected: not read", file=sys.stderr)
        return None
    return 100.0 * t.steps * sum(w.seconds() for w in work) / t.device_seconds(pick)
