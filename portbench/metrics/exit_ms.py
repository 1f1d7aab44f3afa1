"""exit_ms: device time per sampler step of the ATen kernels launched inside
the serving call's `adm.exit` spans: each block's exit (the slice of the
conv's columns, the casts, the residual add).  A port kernel launched there
(K7, under `boundary_fusion`) is not counted.  Nothing is read where the
trace holds no such span (a program without it)."""

SPAN = "adm.exit"


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not any(h["name"] == SPAN for h in t.host):
        return None
    return t.device_seconds(lambda k: k.aten and SPAN in k.spans) / t.steps * 1e3
