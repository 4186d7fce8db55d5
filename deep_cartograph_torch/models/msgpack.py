"""The msgpack subset of a Flax parameter file, in plain Python.

The JAX package writes a deep CV's parameters with Flax's `to_bytes`
(`flax_params.msgpack` in model.zip): a msgpack map of str keys whose
leaves are numpy arrays, each stored as an extension of type 1 holding a
msgpack array (shape, dtype name, raw C-order bytes). This module reads and
writes that subset (maps, arrays, str, bin, ints, floats, nil, bool, and the
ndarray and numpy-scalar extensions) so the port needs neither msgpack nor
Flax. `packb` of a tree of dicts and float32 arrays gives the bytes Flax
writes for it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1   # Flax's _MsgpackExtType.ndarray
EXT_NPSCALAR = 3  # Flax's _MsgpackExtType.npscalar


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                             (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(n)


def _pack_int(n: int) -> bytes:
    if n >= 0:
        return _pack_uint(n)
    if n >= -32:
        return struct.pack(">b", n)
    for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                             (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if n >= -limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(n)


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> bytes:
    """Header of a str/bin/array/map of length n (codes: 8-, 16-, 32-bit)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(n)


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot be packed")
    return packb((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj` (dicts with str keys, lists/tuples, numpy
    arrays and scalars, str, bytes, int, float, bool, None)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        out += _pack_ext(EXT_NDARRAY, _pack_ndarray(obj))
    elif isinstance(obj, np.generic):
        out += _pack_ext(EXT_NPSCALAR, _pack_ndarray(np.asarray(obj)))
    elif isinstance(obj, int):
        out += _pack_int(obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data
    elif isinstance(obj, (bytes, bytearray)):
        out += _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    elif isinstance(obj, (list, tuple)):
        out += _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out += _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {key!r}")
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def unpackb(data: bytes) -> Any:
    """The object that `data` encodes (arrays decode to numpy arrays)."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes")
    return obj


def _read(buf: memoryview, pos: int, fmt: str) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, buf, pos)[0], pos + size


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, raw = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(bytes(raw), dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB):
        n, pos = _read(buf, pos, {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                                  0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        raw = bytes(buf[pos:pos + n])
        return (raw if b <= 0xC6 else raw.decode("utf-8")), pos + n
    if b in (0xC7, 0xC8, 0xC9):
        n, pos = _read(buf, pos, {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code, pos = _read(buf, pos, ">b")
        return _ext(code, bytes(buf[pos:pos + n])), pos + n
    if 0xD4 <= b <= 0xD8:
        n = 1 << (b - 0xD4)
        code, pos = _read(buf, pos, ">b")
        return _ext(code, bytes(buf[pos:pos + n])), pos + n
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        return _read(buf, pos, scalars[b])
    if b in (0xDC, 0xDD):
        n, pos = _read(buf, pos, ">H" if b == 0xDC else ">I")
        return _unpack_array(buf, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _read(buf, pos, ">H" if b == 0xDE else ">I")
        return _unpack_map(buf, pos, n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpack_array(buf: memoryview, pos: int, n: int):
    items = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        items.append(item)
    return items, pos


def _unpack_map(buf: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        value, pos = _unpack(buf, pos)
        out[key] = value
    return out, pos
