"""attn_roofline: K3, the whole attention block (ops/int8_attention.
fused_attention_block: its GroupNorm launch, four GEMMs and the attention
core): the blocks' least time over the device time of every kernel launched
inside the harness's span around each call.  Nothing is read where the
calls found are not the ones the configuration's shapes give."""
import sys


def read(rec):
    t = rec.trace
    if t is None or not t.steps:
        return None
    calls = sum(1 for h in t.host if h["name"] == "portbench.K3")
    want = len(rec.work["K3"]) * t.steps
    if calls == 0 or calls != want:
        print(f"[portbench] attn_roofline: {calls} K3 calls traced, {want} expected: not read", file=sys.stderr)
        return None
    return 100.0 * t.steps * sum(w.seconds() for w in rec.work["K3"]) / t.device_seconds(
        lambda k: "portbench.K3" in k.spans)
