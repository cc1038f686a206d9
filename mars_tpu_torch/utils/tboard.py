"""TensorBoard event-file writer, stdlib only (the port's own copy of
``mars_tpu/utils/tboard.py``: for the same tag, value, step and wall time
it writes the same bytes).

The reference streams per-episode metrics to TensorBoardX and Comet
(reference: mars/utils/logger.py:197, 234-294).  This module writes
standard TensorBoard event files directly: TFRecord-framed `Event` protos
with `Summary.simple_value` scalars, hand-encoded on the protobuf wire
format.  Any stock TensorBoard reads the result
(`tensorboard --logdir <dir>`).

Wire formats (both public, fixed specs):
  * TFRecord frame: u64-LE length | masked crc32c(length) | payload |
    masked crc32c(payload)
  * Event proto:   1: wall_time (double), 2: step (int64),
                   3: file_version (string, first record only),
                   5: summary { repeated 1: value { 1: tag (string),
                                                    2: simple_value (f32) } }
"""
from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _build_table():
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _i64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _bytes(1, tag.encode()) + _f32(2, float(value))
    summary = _bytes(1, val)
    return _f64(1, wall_time) + _i64(2, step) + _bytes(5, summary)


class SummaryWriter:
    """Scalar-only TensorBoard writer (tensorboardX.SummaryWriter shape)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(logdir, fname), "wb")
        self._record(_f64(1, time.time()) +
                     _bytes(3, b"brain.Event:2"))  # file_version header

    def _record(self, payload: bytes):
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float = None):
        self._record(_scalar_event(tag, value, step,
                                   time.time() if wall_time is None
                                   else wall_time))

    def add_scalars(self, step: int, **scalars):
        t = time.time()
        for tag, v in scalars.items():
            self._record(_scalar_event(tag, float(v), step, t))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_records(path: str) -> list:
    """The payloads of an event file, in order; raises ValueError where a
    record's length or payload fails its masked crc32c or is cut short."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: record header cut short at byte {pos}")
        hdr = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", hdr)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != _masked_crc(hdr):
            raise ValueError(f"{path}: length crc mismatch at byte {pos}")
        payload = data[pos + 12:pos + 12 + n]
        tail = data[pos + 12 + n:pos + 16 + n]
        if len(payload) != n or len(tail) != 4:
            raise ValueError(f"{path}: record cut short at byte {pos}")
        if struct.unpack("<I", tail)[0] != _masked_crc(payload):
            raise ValueError(f"{path}: payload crc mismatch at byte {pos}")
        out.append(payload)
        pos += 16 + n
    return out
