"""Native (C++) runtime components, loaded with ctypes (port of
`attentiondm_tpu/native`).

`write_png_batch`: the multithreaded zlib PNG batch writer of the bulk
`--fid` image dump, built from this package's copy of `png_writer.cc` with
g++ at first use into `attentiondm_tpu_torch/_build/` (git-ignored), keyed
by a hash of the source.  A build that fails raises with the compiler's
error; nothing falls back to another encoder (`utils/images.write_png_batch`
is the plain version, the same pixels through Python's zlib).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.images import to_uint8

SRC = Path(__file__).resolve().parent / "png_writer.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the writer unless this source hash is built (into a name of
    this process's, then renamed, so concurrent builds do not collide).
    Raises RuntimeError with g++'s output when the build fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libpngwriter_{h}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-lz", "-o", str(tmp)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native PNG writer: cannot run g++ ({e})") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native PNG writer: g++ failed ({r.returncode}) on {SRC}:\n{r.stderr.strip()}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.write_png_batch.restype = ctypes.c_int
            lib.write_png_batch.argtypes = [ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the writer builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def write_png_batch(images01, out_dir: str, start_index: int, threads: int = 0) -> int:
    """Write [N, H, W, 3] images (float [0, 1], clipped, * 255 + 0.5 and
    truncated; or uint8 pixels as they are) as <out_dir>/<start_index + i>.png
    on `threads` threads (0: one a core).  Returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    imgs = np.ascontiguousarray(to_uint8(images01))
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"write_png_batch expects RGB [N, H, W, 3], got {imgs.shape}")
    n, h, w, _ = imgs.shape
    failed = _load().write_png_batch(imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n, h, w,
                                     (out_dir.rstrip("/") + "/").encode(), start_index, threads)
    if failed:
        raise IOError(f"{failed} PNG writes failed under {out_dir}")
    return n
