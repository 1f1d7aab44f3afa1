"""attentiondm_tpu_torch — the PyTorch / CUDA port of `attentiondm_tpu`.

It runs the W4A8 int8 serving sampler on one NVIDIA Hopper GPU: the FP
teacher trajectory, stage-1 range calibration, the per-step weight fold and
the fused int8 serving DDIM sampler.  The modules mirror the JAX package's
layout and names; the TPU kernels that path reaches (the int8 conv core,
the resblock GroupNorm entry, epilogue and exit, the whole resblock and the
whole attention block) are CUDA C++ kernels under `csrc/`, built for
`sm_90a` at first use (`ops/_build.py`).

The JAX package stays the reference: this package imports neither `jax` nor
`attentiondm_tpu`, so it runs on a machine that has no JAX.
"""

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device an entry point uses when its caller names none: the
    current CUDA device.  Without one it raises; nothing falls back to the
    CPU on its own (pass `device="cpu"` to ask for it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("attentiondm_tpu_torch runs on a CUDA device and found none; pass "
                           "device=\"cpu\" to run the plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
