"""step_device_ms: device kernel time of the traced calls over their
sampler steps (the serving forward and the DDIM update)."""


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not t.kernels:
        return None
    return t.device_seconds(lambda k: True) / t.steps * 1e3
