"""bedroom_step_mfu: the whole ADM step's share of the card's peak: the
least time of a step's products (int8 convs and GEMMs at 1,979 TOP/s, the
attention cores' float32 products as 3xTF32 at 495/3 TFLOP/s) over the
traced wall time per step."""
from portbench.roofline.peaks import INT8_OPS_PER_S, TF32X3_FLOPS_PER_S


def read(rec):
    t = rec.trace
    if t is None or not t.steps:
        return None
    ops_s = (sum(w.int8_ops for w in rec.work["K1"]) / INT8_OPS_PER_S
             + sum(w.tf32x3_flops for w in rec.work["core"]) / TF32X3_FLOPS_PER_S)
    return 100.0 * ops_s / (t.window_s / t.steps)
