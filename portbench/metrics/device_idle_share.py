"""device_idle_share: the share of the traced window in which no operation
ran on the device (one minus the union of kernel, copy and set intervals)."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
