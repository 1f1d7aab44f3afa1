"""mha_roofline: ADM's multi-head attention core, K11 with heads
(ops/attention.head_attention, csrc/flash_attention.cu): the least time of
the step's cores (q, k, v and the output once in float32; 4 L^2 C float32
operations an image at the 3xTF32 tensor-core rate, the float32-exact peak
that `core` and K3's core are priced at) over the device time of its
launches in the traced steps.  Nothing is read where the
launches found are not the ones the configuration's shapes give."""
import sys


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not rec.work.get("K11"):
        return None
    pick = lambda k: not k.aten and "flash_attention_kernel" in k.name  # noqa: E731
    n, want = t.count(pick), len(rec.work["K11"]) * t.steps
    if n == 0 or n != want:
        print(f"[portbench] mha_roofline: {n} K11 launches traced, {want} expected: not read", file=sys.stderr)
        return None
    return 100.0 * t.steps * sum(w.seconds() for w in rec.work["K11"]) / t.device_seconds(pick)
