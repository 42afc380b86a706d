"""Reader for the reference package's flax msgpack checkpoints, using only
the standard library and numpy.

The checkpoints are written by `flax.serialization.to_bytes` (see
`alphagomoku_tpu/training/manager.py`): a msgpack map tree whose leaves
are msgpack ext values, type 1 for an ndarray (payload: a msgpack array
`[shape, dtype name, C-order bytes]`) and type 3 for a numpy scalar
(payload: `[dtype name, bytes]`).  `restore` decodes such bytes into
nested dicts of numpy arrays, as `flax.serialization.msgpack_restore`
does.
"""

from __future__ import annotations

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
        if code == _EXT_NDARRAY:
            shape, dtype, buf = unpackb(payload)
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        if code == _EXT_NPSCALAR:
            dtype, buf = unpackb(payload)
            return np.frombuffer(buf, dtype=np.dtype(dtype))[0]
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
