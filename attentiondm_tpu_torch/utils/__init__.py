"""Image output, metrics logging and profiling helpers (port of `attentiondm_tpu/utils`)."""
from .images import save_image, save_image_grid
from .metrics_log import AverageMeter, MetricsLogger

__all__ = ["save_image", "save_image_grid", "MetricsLogger", "AverageMeter"]
