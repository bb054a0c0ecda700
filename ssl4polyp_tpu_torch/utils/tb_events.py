"""Minimal pure-python TensorBoard event-file writer (scalars only).

The port's copy of ``ssl4polyp_tpu/utils/tb_events.py``.
``torch.utils.tensorboard.SummaryWriter`` (the reference's sink,
``src/ssl4polyp/classification/utils/tensorboard.py:129``) needs the
``tensorboard`` package, which a host may lack; :class:`..logging.RunLogger`
then falls back to this writer.  It hand-encodes the two protobufs a scalar
stream needs (``Event`` and ``Summary.Value.simple_value``) plus the TFRecord
framing (length + masked crc32c), producing files TensorBoard loads natively
— ~100 lines, zero dependencies.

Wire format (TFRecord): ``uint64 length | uint32 masked_crc(length) |
data | uint32 masked_crc(data)``; crc is CRC-32C (Castagnoli), masked per
``tensorflow/core/lib/hash/crc32c.h``.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from pathlib import Path

__all__ = ["ScalarEventWriter"]

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), table-driven; scalar event volume is tiny.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli polynomial
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Hand-rolled protobuf encoding for Event / Summary / Summary.Value.
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1  # two's-complement for negative int64 steps
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def _field_double(number: int, value: float) -> bytes:
    return _varint((number << 3) | 1) + struct.pack("<d", value)


def _field_float(number: int, value: float) -> bytes:
    return _varint((number << 3) | 5) + struct.pack("<f", value)


def _field_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _event(wall_time: float, *, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    parts = [_field_double(1, wall_time)]
    if step:
        parts.append(_field_varint(2, step))
    if file_version:
        parts.append(_field_bytes(3, file_version.encode("utf-8")))
    if summary:
        parts.append(_field_bytes(5, summary))
    return b"".join(parts)


def _scalar_summary(tag: str, value: float) -> bytes:
    value_msg = _field_bytes(1, tag.encode("utf-8")) + _field_float(2, value)
    return _field_bytes(1, value_msg)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class ScalarEventWriter:
    """Drop-in for the ``add_scalar``/``flush``/``close`` subset of
    ``torch.utils.tensorboard.SummaryWriter``."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.time()
        name = f"events.out.tfevents.{int(stamp)}.{socket.gethostname()}.{os.getpid()}"
        self._path = self.log_dir / name
        self._lock = threading.Lock()
        self._handle = open(self._path, "ab")
        self._write_record(_event(stamp, file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        framed = (
            header
            + struct.pack("<I", _masked_crc(header))
            + data
            + struct.pack("<I", _masked_crc(data))
        )
        with self._lock:
            self._handle.write(framed)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _event(time.time(), step=int(step),
                   summary=_scalar_summary(tag, float(value)))
        )

    def flush(self) -> None:
        with self._lock:
            self._handle.flush()

    def close(self) -> None:
        with self._lock:
            if not self._handle.closed:
                self._handle.flush()
                self._handle.close()
