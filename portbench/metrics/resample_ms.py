"""resample_ms: device time per sampler step of the kernels launched inside
the serving call's `adm.resample` spans: ADM's resampling resblocks' 2x2
average pools and nearest x2 repeats, of conv1's input (the int8 codes of an
upsampling block) and of the skip path.  Nothing is read where the trace
holds no such span (a program without it)."""

SPAN = "adm.resample"


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not any(h["name"] == SPAN for h in t.host):
        return None
    return t.device_seconds(lambda k: SPAN in k.spans) / t.steps * 1e3
