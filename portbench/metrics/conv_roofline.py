"""conv_roofline: K1, the int8 implicit-GEMM conv core (csrc/igemm.cuh), in
all its modes and callers (K3's projections too): the least time of every
int8 conv / GEMM launch of the traced steps over those launches' device
time.  Nothing is read where the launches found are not the ones the
configuration's shapes give."""
import sys


def read(rec):
    t = rec.trace
    if t is None or not t.steps:
        return None
    pick = lambda k: not k.aten and "igemm" in k.name  # noqa: E731
    n, want = t.count(pick), len(rec.work["K1"]) * t.steps
    if n == 0 or n != want:
        print(f"[portbench] conv_roofline: {n} K1 launches traced, {want} expected: not read", file=sys.stderr)
        return None
    return 100.0 * t.steps * sum(w.seconds() for w in rec.work["K1"]) / t.device_seconds(pick)
