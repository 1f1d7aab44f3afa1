"""Build and load the CUDA kernels under `attentiondm_tpu_torch/csrc/`.

The sources are compiled with nvcc for `sm_90a` into one shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
into `attentiondm_tpu_torch/_build/` (listed in .gitignore), keyed by a hash
of the sources, so a fresh checkout builds itself.  A missing nvcc or a
failed build raises; nothing falls back.

Compile flags: `-fmad=false` keeps nvcc from contracting `a*b - c` into one
FMA, so every quantize and dequantize step rounds its product first, as
torch's plain versions and JAX do; the kernels write `fma` where they want
one (the attention core's f64 sums of f32 products, which are exact in f64
either way).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (every launcher returns cudaGetLastError())
SIGNATURES = {
    # xp, gq, inv_ws, zcbias, out, B, Hp, Wp, Cp, Ho, Wo, Np, ksize, stride, mode, stream
    "adm_int8_conv": [_P] * 5 + [_I] * 10 + [_P],
    # x, x_is_int32, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp, out,
    # B, HW, N, groups, n_levels, inv_count, stream
    "adm_epilogue_gn_swish_quant": [_P, _I] + [_P] * 8 + [_I] * 5 + [_F, _P],
    # x, gn (2,C), sqkv (6,C), n_q, n_k, n_v, wq, wk, wv, eqkv (6,C), sqo (4,C), n_o, wo,
    # scratch q8 k8 v8 qf kf vf o8, out, B, L, C, groups, inv_count, scale, stream
    "adm_fused_attention_block": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]
    + [_P] * 8 + [_I] * 4 + [_F, _F, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if nvcc is None and toolkit.exists():
        nvcc = str(toolkit)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build from csrc/ on a machine with the "
                           "CUDA toolkit (on PATH or under $CUDA_HOME)")
    return nvcc


def build() -> tuple[Path, float]:
    """Compile the library unless this source hash is already built.
    Returns (path, seconds spent compiling)."""
    so = BUILD_DIR / f"libadm_kernels_{source_hash()}.so"
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    cus, _ = _sources()
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cus)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    os.replace(tmp, so)
    return so, seconds


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors):
    """Every tensor a kernel takes: on the same CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
