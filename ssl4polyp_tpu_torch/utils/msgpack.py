"""The msgpack subset that the checkpoint files use, written out in Python.

The JAX package writes its ``.ckpt`` files with
``flax.serialization.msgpack_serialize`` and reads them with
``msgpack_restore``.  This module encodes and decodes the same bytes without
importing ``flax``, ``msgpack`` or ``jax``: nil, bool, ints, float32/64, str,
bin, array, map, and flax's extension types (an ndarray as ext 1: a packed
``(shape, dtype name, raw bytes)`` tuple; a numpy scalar as ext 3; a native
complex as ext 2).  :func:`packb` on a document gives flax's bytes for it
(dictionaries are written with sorted keys at every level, as the tree map
in flax's writer leaves them), and :func:`unpackb` reads what either writer
wrote.

Above 2**30 bytes per array flax splits an array into chunks: that form is
read here, and refused on write with ``NotImplementedError``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["packb", "unpackb"]

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


def _pack_int(value: int, out: bytearray) -> None:
    if 0 <= value < 0x80:
        out += struct.pack("B", value)
    elif -0x20 <= value < 0:
        out += struct.pack("b", value)
    elif 0x80 <= value <= 0xFF:
        out += struct.pack("BB", 0xCC, value)
    elif -0x80 <= value < 0:
        out += struct.pack(">Bb", 0xD0, value)
    elif 0xFF < value <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, value)
    elif -0x8000 <= value < -0x80:
        out += struct.pack(">Bh", 0xD1, value)
    elif 0xFFFF < value <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, value)
    elif -0x80000000 <= value < -0x8000:
        out += struct.pack(">Bi", 0xD2, value)
    elif 0xFFFFFFFF < value <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, value)
    elif -0x8000000000000000 <= value < -0x80000000:
        out += struct.pack(">Bq", 0xD3, value)
    else:
        raise OverflowError(f"integer {value} does not fit msgpack's 64 bits")


def _pack_header(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A length header: the fix form up to ``fix_max``, then ``codes`` =
    ((code, struct format, largest length), ...) in growing width."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out += struct.pack(">B" + fmt, code, n)
            return
    raise ValueError(f"length {n} exceeds msgpack's 32 bits")


def _pack_str(value: str, out: bytearray) -> None:
    raw = value.encode("utf-8")
    _pack_header(len(raw), 0xA0, 31,
                 ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF)), out)
    out += raw


def _pack_bin(raw: bytes, out: bytearray) -> None:
    _pack_header(len(raw), 0, -1,
                 ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF)), out)
    out += raw


def _pack_array_header(n: int, out: bytearray) -> None:
    _pack_header(n, 0x90, 15, ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF)), out)


def _pack_ext(code: int, raw: bytes, out: bytearray) -> None:
    n = len(raw)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack("Bb", fixed[n], code)
    elif n <= 0xFF:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        out += struct.pack(">BHb", 0xC8, n, code)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BIb", 0xC9, n, code)
    else:
        raise ValueError(f"extension of {n} bytes exceeds msgpack's 32 bits")
    out += raw


def _ndarray_bytes(array: np.ndarray) -> bytes:
    """flax's ndarray encoding: the packed (shape, dtype name, C-order bytes)."""
    if array.dtype.hasobject or array.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if array.size * array.dtype.itemsize > MAX_CHUNK_SIZE:
        raise NotImplementedError(
            f"an array of {array.size * array.dtype.itemsize} bytes is above the "
            f"{MAX_CHUNK_SIZE}-byte limit past which the format chunks arrays; "
            "writing chunked arrays is not supported")
    out = bytearray()
    _pack_array_header(3, out)
    _pack_array_header(array.ndim, out)
    for dim in array.shape:
        _pack_int(int(dim), out)
    _pack_str(array.dtype.name, out)
    _pack_bin(array.tobytes("C"), out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    kind = type(obj)  # exact types, as msgpack's strict_types packs them
    if obj is None:
        out.append(0xC0)
    elif kind is bool:
        out.append(0xC3 if obj else 0xC2)
    elif kind is int:
        _pack_int(obj, out)
    elif kind is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif kind is str:
        _pack_str(obj, out)
    elif kind in (bytes, bytearray):
        _pack_bin(bytes(obj), out)
    elif kind is list:
        _pack_array_header(len(obj), out)
        for item in obj:
            _pack(item, out)
    elif kind is dict:
        _pack_header(len(obj), 0x80, 15, ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF)), out)
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif kind is complex:
        raw = bytearray([0x92])
        raw += struct.pack(">Bd", 0xCB, obj.real) + struct.pack(">Bd", 0xCB, obj.imag)
        _pack_ext(_EXT_COMPLEX, bytes(raw), out)
    else:
        raise TypeError(f"cannot serialize {kind.__name__} (tuples and other containers are "
                        "not part of the checkpoint format: use lists and dicts)")


def packb(document: Any) -> bytes:
    """``document`` (dicts, lists, Python scalars, numpy arrays and scalars)
    as the bytes ``flax.serialization.msgpack_serialize`` gives for it."""
    out = bytearray()
    _pack(document, out)
    return bytes(out)


# Type bytes followed by a number, and by a length, with their struct formats.
_NUMBERS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
_LENGTHS = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H", 0xDB: "I",
            0xDC: "H", 0xDD: "I", 0xDE: "H", 0xDF: "I", 0xC7: "B", 0xC8: "H", 0xC9: "I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data, raw: bool) -> None:
        self.data = memoryview(data)
        self.pos = 0
        # flax's inner ndarray tuple: str stays bytes, and bin stays a view of
        # `data`, so that an array's bytes are never copied.
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def number(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        result = {}
        for _ in range(n):
            key = self.read()
            result[key] = self.read()
        return result

    def ext(self, n: int):
        code = self.number("b")
        return _unpack_ext(code, self.take(n))

    def read(self) -> Any:
        b = self.number("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _NUMBERS:
            return self.number(_NUMBERS[b])
        if b in _LENGTHS:
            n = self.number(_LENGTHS[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n) if self.raw else bytes(self.take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return self.text(n)
            if b in (0xDC, 0xDD):
                return self.array(n)
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not part of the checkpoint format")


def _dtype_from_name(name: bytes) -> np.dtype:
    if name == b"bfloat16":
        try:
            import ml_dtypes
        except ImportError as exc:
            raise NotImplementedError(
                "the checkpoint holds a bfloat16 array, which numpy reads only with the "
                "ml_dtypes package installed") from exc
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name.decode("ascii"))


def _ndarray_from_bytes(data) -> np.ndarray:
    reader = _Reader(data, raw=True)
    shape, dtype_name, buffer = reader.read()
    return np.frombuffer(buffer, dtype=_dtype_from_name(dtype_name)).reshape(shape, order="C")


def _unpack_ext(code: int, data: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = _Reader(data, raw=False).read()
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not part of the checkpoint format")


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays (written above ``MAX_CHUNK_SIZE`` bytes) back
    into arrays; every other node as it is."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def unpackb(data: bytes) -> Any:
    """The document that :func:`packb` or flax's writer encoded: dicts, lists,
    Python scalars, numpy arrays (read-only views of ``data``) and scalars."""
    reader = _Reader(data, raw=False)
    document = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes follow the msgpack document")
    return _unchunk(document)
