"""setup_s: from the process's start to the first timed call: loading,
weights, the FP teacher, calibration, the fold, the warm-up call and, in a
checkout's first run, the kernels' build."""


def read(rec):
    return rec.setup_s
