"""fold_s: the port's per-step W4 fold (`prepare_serving_runtime`, inside
`serving_ddim_sampler`), host seconds ended by a device sync."""


def read(rec):
    return rec.seconds.get("fold_s")
