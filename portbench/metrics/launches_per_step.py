"""launches_per_step: every kernel launched in the traced calls, over the
sampler steps they ran (an exact count)."""


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not t.kernels:
        return None
    return t.count(lambda k: True) / t.steps
