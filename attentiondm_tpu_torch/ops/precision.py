"""The float32 precision switch of the port's plain float32 math."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """Full-precision float32 products on the GPU, for the duration of a
    call (a context manager, or a decorator as `@exact_f32()`).

    cuDNN runs float32 convolutions in TF32 by default; the calibration
    ranges are read off these float32 activations, so both TF32 switches are
    off while the port runs float32 math, and restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
