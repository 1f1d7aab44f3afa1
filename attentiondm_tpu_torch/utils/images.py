"""PNG output (port of `attentiondm_tpu/utils/images.py` and of the batch
writer `attentiondm_tpu/native.write_png_batch`).

The encoder is the standard library's: each row gets filter byte 0 (none),
the rows are deflated by `zlib` (level 1, as the native writer), and the
chunks carry `binascii.crc32` sums.  No imaging package is needed.  A batch
is encoded on a thread pool (zlib releases the GIL), each file written
under a temporary name and renamed into place, so an interrupted run leaves
no half-written `<id>.png`.  `read_png` decodes any 8-bit non-interlaced
PNG (the five row filters, grey, grey + alpha, RGB, RGBA and palette
images), `to_rgb` converts it as PIL's `.convert("RGB")` does.
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


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel (grey, RGB, palette, grey + alpha, RGBA)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The rows [h, stride] of a PNG's inflated data [h, 1 + stride]: each
    row's filter (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth) undone against
    the reconstructed row above, `bpp` bytes a pixel."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, f = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            row = f
        elif kind == 1:  # Sub: a running sum along each of the pixel's bytes
            row = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            row = (f + prior) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: pixel by pixel, left to right
            row = np.zeros(stride, np.int32)
            left, upleft = np.zeros(bpp, np.int32), np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
                left = (f[x:x + bpp] + pred) & 0xFF
                row[x:x + bpp] = left
                upleft = up
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = row
        prior = row.astype(np.int32)
    return out


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W, C] of an 8-bit non-interlaced PNG, any row filter: C is
    1 (grey), 2 (grey + alpha), 3 (RGB, or a palette image expanded) or 4
    (RGBA), as stored.  Other depths and interlaced files raise ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr, palette = 8, [], None, None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != binascii.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    c = _CHANNELS.get(ctype)
    if depth != 8 or c is None or interlace or (ctype == 3 and palette is None):
        raise ValueError(f"{path}: depth {depth}, colour type {ctype}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    rows = raw[:, 1:].copy() if not raw[:, 0].any() else _unfilter(raw, h, w * c, c)
    img = rows.reshape(h, w, c)
    return palette[img[..., 0]] if ctype == 3 else img


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] of a `read_png` image, as PIL's `.convert("RGB")`
    makes it: grey repeated into the three channels, alpha dropped."""
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


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
