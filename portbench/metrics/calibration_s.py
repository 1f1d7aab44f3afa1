"""calibration_s: the port's stage-1 calibration (`quant/calibrate.calibrate_ranges`), host
seconds ended by a device sync."""


def read(rec):
    return rec.seconds.get("calibration_s")
