"""flax's msgpack checkpoint format, read and written without msgpack.

The JAX package writes its ``best``/``last`` checkpoints with
``flax.serialization.to_bytes``: a msgpack map of string keys whose leaves
are numpy arrays packed as ext type 1 (the msgpack encoding of
``(shape, dtype name, C-order bytes)``) and numpy scalars as ext type 3
(the same payload of a 0-d array).  This module decodes and encodes
exactly that subset of msgpack — maps with string keys, str, bin, int,
float, nil, bool, arrays (inside the ndarray payload) and those two ext
types — so the port needs no msgpack package.  It raises on flax's
chunked-array form (arrays over 1 GiB, never written for this model) and
on any other type it does not know.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            n = self.uint(2 if b == 0xDC else 4)
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by flax "
                         "checkpoints")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, str):
                raise ValueError(f"msgpack map key {k!r} is not a string")
            out[k] = self.obj()
        if _CHUNKED_KEY in out:
            raise ValueError("flax's chunked-array form (arrays over 1 GiB) "
                             "is not supported")
        return out

    def ext(self, n: int):
        code = self.sint(1)
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an ndarray "
                             "(1) or numpy scalar (3)")
        arr = _ndarray_from_payload(payload)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"array dtype {name!r} is not a numpy dtype") from e
    if dtype.type.__module__ != "numpy":   # e.g. ml_dtypes' bfloat16
        raise ValueError(f"array dtype {name!r} is not a numpy dtype")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes):
    """Decode one msgpack object that fills ``data``."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return out


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v >= 0:
        for code, n in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * n):
                return bytes([code]) + v.to_bytes(n, "big")
    else:
        for code, n in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * n - 1)):
                return bytes([code]) + v.to_bytes(n, "big", signed=True)
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _sized(n: int, fix, codes) -> bytes:
    """Header of a str/bin/array/map of length ``n``: ``fix`` is
    (base, limit) of the fix form or None, ``codes`` the (code, width)
    forms by increasing width."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, width in codes:
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    head = bytes([fixed[n]]) if n in fixed else \
        _sized(n, None, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
    return head + bytes([code]) + payload


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj))))
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_sized(len(raw), (0xA0, 32),
                          ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_sized(len(raw), None,
                          ((0xC4, 1), (0xC5, 2), (0xC6, 4))) + raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), (0x90, 16), ((0xDC, 2), (0xDD, 4))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), (0x80, 16), ((0xDE, 2), (0xDF, 4))))
        if not all(isinstance(k, str) for k in obj):
            raise ValueError(f"map keys {list(obj)} are not all strings")
        for k in sorted(obj):   # flax writes maps in sorted key order
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise ValueError(f"cannot pack {type(obj).__name__} into a flax "
                         "checkpoint")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be packed")
    return packb([list(arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes()])


def packb(obj) -> bytes:
    """Encode ``obj`` (nested string-keyed dicts of numpy arrays, numpy
    scalars and Python scalars) as ``flax.serialization.to_bytes`` does."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
