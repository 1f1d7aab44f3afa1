"""PNG output (port of `attentiondm_tpu/utils/images.py` and of the batch
writer `attentiondm_tpu/native.write_png_batch`).

The encoder is the standard library's: each row gets filter byte 0 (none),
the rows are deflated by `zlib` (level 1, as the native writer), and the
chunks carry `binascii.crc32` sums.  No imaging package is needed.  A batch
is encoded on a thread pool (zlib releases the GIL), each file written
under a temporary name and renamed into place, so an interrupted run leaves
no half-written `<id>.png`.  `read_png` decodes the files this module
writes (8-bit, filter 0).
"""
from __future__ import annotations

import binascii
import math
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (grey, RGB, RGBA)


def to_uint8(x) -> np.ndarray:
    """Float [0, 1] pixels -> uint8: clip, * 255 + 0.5, truncate (uint8 input passes as it is)."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """PNG bytes of one uint8 image [H, W] or [H, W, C], C in 1, 3, 4."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if img.dtype != np.uint8 or c not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes uint8 [H, W, 1 | 3 | 4], got {img.dtype} {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b"")


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W, C] of an 8-bit PNG whose rows all use filter 0 (this
    module's files); anything else raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != binascii.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    c = {v: k for k, v in _COLOR_TYPE.items()}.get(ctype)
    if depth != 8 or c is None or interlace:
        raise ValueError(f"{path}: depth {depth}, colour type {ctype}, interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, c).copy()


def _write(path: str, png: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)


def _save(arr: np.ndarray, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write(path, encode_png(arr))


def save_image(x, path: str):
    """Save one HWC float [0, 1] image as a PNG."""
    _save(to_uint8(x), path)


def save_image_grid(xs, path: str, nrow: int | None = None, pad: int = 2):
    """Save a batch [N, H, W, C] as one tiled PNG: `nrow` images a row
    (default ceil(sqrt(N))), `pad` white pixels between them."""
    xs = np.asarray(xs)
    n, h, w, c = xs.shape
    nrow = nrow or int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) - pad, nrow * (w + pad) - pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * (h + pad):r * (h + pad) + h, col * (w + pad):col * (w + pad) + w] = xs[i]
    _save(to_uint8(grid), path)


def write_png_batch(images, out_dir: str, start_index: int, threads: int = 0) -> int:
    """Write [N, H, W, 3] images (float [0, 1], or uint8 pixels as they
    are) as <out_dir>/<start_index + i>.png on `threads` threads (0: one a
    core).  Returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    imgs = to_uint8(images)
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"write_png_batch expects RGB [N, H, W, 3], got {imgs.shape}")
    workers = threads or os.cpu_count() or 1
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(lambda i: _write(os.path.join(out_dir, f"{start_index + i}.png"), encode_png(imgs[i])),
                      range(imgs.shape[0])))
    return imgs.shape[0]
