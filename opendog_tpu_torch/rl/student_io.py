"""Reader of the students that the JAX package saves (``student.msgpack``).

The JAX package writes a student's parameters with
``flax.serialization.to_bytes``: msgpack maps of strings, each array an
ext of type 1 whose data is itself msgpack, ``[shape, dtype name, bytes]``
in C order.  This module decodes that format in plain Python into the
nested dict of numpy arrays that ``flax.serialization.msgpack_restore``
returns, so the committed students load where neither msgpack nor flax is
installed.  It reads; it does not write.
"""
from __future__ import annotations

import struct

import numpy as np

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """A msgpack decoder over one bytes object."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}        # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), self.take(fixext[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no "
                         "msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    @staticmethod
    def ext(code: int, data: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            re, im = loads(data)
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not flax's")


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = loads(data)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def loads(data: bytes):
    """The object that the msgpack ``data`` holds; flax's ndarray ext
    becomes a numpy array."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "object")
    return out


def load_params(path: str) -> dict:
    """The parameter tree of a saved student: ``{"params": {"Dense_0":
    {"kernel": ..., "bias": ...}, ..., "log_std": ...}}`` of numpy
    arrays."""
    with open(path, "rb") as f:
        return loads(f.read())
