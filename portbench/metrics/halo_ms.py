"""halo_ms: device time per sampler step of the ATen kernels launched inside
the serving call's `adm.halo` spans: each K1 input's preparation, the
quantized-zero halo (`pad_qzero`, the stride-2 halo's copy) and the channel
pad to K1's 128 grid.  Nothing is read where the trace holds no such span
(a program without it)."""

SPAN = "adm.halo"


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not any(h["name"] == SPAN for h in t.host):
        return None
    return t.device_seconds(lambda k: k.aten and SPAN in k.spans) / t.steps * 1e3
