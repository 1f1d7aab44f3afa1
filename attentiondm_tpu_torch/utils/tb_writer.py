"""Dependency-free TensorBoard event writer (port of
`attentiondm_tpu/utils/tb_writer.py`, the same bytes for the same wall time).

The runner logs the training loss as a TensorBoard scalar stream without
TensorFlow or tensorboard installed: this module writes the
`events.out.tfevents.*` format directly, TFRecord framing with masked
CRC32C checksums around hand-encoded `Event` / `Summary` protobuf messages
(only the scalar subset TensorBoard needs).

Wire format per record:  [len u64le][masked_crc32c(len) u32le][payload]
[masked_crc32c(payload) u32le].  Proto fields encoded:
  Event:   1 wall_time (double), 2 step (int64), 3 file_version (string),
           5 summary (message)
  Summary: repeated 1 value (message)
  Value:   1 tag (string), 2 simple_value (float)
"""
from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — table-driven, with the TFRecord mask
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(val)


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _field_bytes(num: int, val: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(val)) + val


def _event(wall_time: float, step: int | None = None, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if summary is not None:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)  # Summary.value (repeated field 1)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class SummaryWriter:
    """Scalar-only TensorBoard writer (API subset of torch.utils.tensorboard).

    >>> w = SummaryWriter(log_dir)
    >>> w.add_scalar("loss", 0.31, step)
    >>> w.close()
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}.0"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, global_step: int):
        self._write_record(
            _event(time.time(), step=int(global_step), summary=_scalar_summary(tag, value))
        )
        self._f.flush()  # scalars are tiny; flushed so that they survive a run that stops abruptly

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
