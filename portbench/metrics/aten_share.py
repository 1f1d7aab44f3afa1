"""aten_share: the plain-torch glue's share of device kernel time: kernels
launched from inside an ATen op (elementwise, reductions, copies, the
library calls ATen makes), over all kernels of the traced calls."""


def read(rec):
    t = rec.trace
    if t is None or not t.kernels:
        return None
    return 100.0 * t.device_seconds(lambda k: k.aten) / t.device_seconds(lambda k: True)
