"""quant_io_ms: device time per sampler step of the ATen kernels launched
inside the serving call's `adm.quant_io` spans: the quantize before and the
int32 -> float32 dequant after each K1 GEMM outside the fused resblock chain
(shortcuts, resamplers, conv_out, composed attention) and conv_in's fake
quantization.  Nothing is read where the trace holds no such span (a
program without it)."""

SPAN = "adm.quant_io"


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not any(h["name"] == SPAN for h in t.host):
        return None
    return t.device_seconds(lambda k: k.aten and SPAN in k.spans) / t.steps * 1e3
