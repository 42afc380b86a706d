"""Reader and writer of the reference package's flax msgpack checkpoints,
using only the standard library and numpy.

The checkpoints are written by `flax.serialization.to_bytes` (see
`alphagomoku_tpu/training/manager.py`): a msgpack map tree whose leaves
are msgpack ext values, type 1 for an ndarray (payload: a msgpack array
`[shape, dtype name, C-order bytes]`) and type 3 for a numpy scalar
(payload: the same array triple of its 0-d array).  `restore` decodes such bytes into
nested dicts of numpy arrays, as `flax.serialization.msgpack_restore`
does; `to_bytes` encodes such a tree as `flax.serialization.to_bytes`
does (keys in the dicts' own order; each value in the smallest msgpack
form, as the `msgpack` package packs it), and `save` writes it through a
temporary file.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: bytes(self.take(self.unpack(">B"))).decode(),
            0xDA: lambda: bytes(self.take(self.unpack(">H"))).decode(),
            0xDB: lambda: bytes(self.take(self.unpack(">I"))).decode(),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = unpackb(payload)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes):
    """Decode one msgpack value (with flax's ndarray / scalar extensions)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack value")
    return out


def restore(data: bytes) -> dict:
    """Checkpoint bytes -> nested dicts of numpy arrays."""
    return unpackb(data)


def load(path) -> dict:
    with open(path, "rb") as fh:
        return restore(fh.read())


def _head(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A msgpack length header: the fix form up to `fix_max`, else the 8-,
    16- or 32-bit form (`codes`, None where the type has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if v >= low:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return


def _ext(out: bytearray, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _pack(out: bytearray, v) -> None:
    if isinstance(v, dict):
        _head(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, str(k))
            _pack(out, x)
    elif isinstance(v, (np.ndarray, np.generic)):
        arr = np.asarray(v)
        _ext(out, _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR,
             packb((arr.shape, arr.dtype.name, arr.tobytes("C"))))
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, str):
        b = v.encode()
        _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, bytes):
        _head(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif v is None or isinstance(v, bool):
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[v])
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out += struct.pack(">Bd", 0xCB, v)
    else:
        raise TypeError(f"cannot encode {type(v).__name__} as msgpack")


def packb(value) -> bytes:
    """Encode one value as msgpack, ndarrays and numpy scalars as flax's
    extensions (the inverse of `unpackb`)."""
    out = bytearray()
    _pack(out, value)
    return bytes(out)


def to_bytes(tree: dict) -> bytes:
    """Nested dicts of numpy arrays -> checkpoint bytes."""
    return packb(tree)


def save(path, tree: dict) -> None:
    """Write `tree` to `path` through a temporary file, as the reference
    package's training manager writes its checkpoints."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(to_bytes(tree))
    os.replace(tmp, path)
