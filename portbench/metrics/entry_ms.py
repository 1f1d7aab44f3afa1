"""entry_ms: device time per sampler step of the ATen kernels launched inside
the serving call's `adm.entry` spans: each GroupNorm -> swish -> quantize
entry in plain torch (a fused resblock's norm1, norm_out, the composed
attention's GroupNorm, the unfused chain's two).  A port kernel launched
there (K4, under `entry_pallas`) is not counted.  Nothing is read where the
trace holds no such span (a program without it)."""

SPAN = "adm.entry"


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not any(h["name"] == SPAN for h in t.host):
        return None
    return t.device_seconds(lambda k: k.aten and SPAN in k.spans) / t.steps * 1e3
