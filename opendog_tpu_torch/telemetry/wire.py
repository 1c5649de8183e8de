"""msgpack in plain Python, for the telemetry stream and the saved students.

The JAX package sends its telemetry with ``msgpack.packb(packet,
use_bin_type=True)`` and reads it with ``msgpack.unpackb(data,
raw=False)``.  Not every machine the port runs on has the ``msgpack``
package, so this module writes and reads the format itself:

* :func:`dumps` writes the types of the telemetry schema (maps, strings,
  floats, ints, bools, lists, ``None`` and bytes) as ``msgpack.packb`` does
  with ``use_bin_type=True``, byte for byte: the smallest form of each int
  and length, every float as float64 (``0xcb``), strings as str and bytes
  as bin;
* :class:`Reader` / :func:`loads` read any msgpack object; an ext type is
  handed to :meth:`Reader.ext`, which a subclass gives its meaning
  (``rl/student_io.py`` reads flax's arrays that way).
"""
from __future__ import annotations

import struct


def _header(n: int, fix: int, fix_max: int, forms) -> bytes:
    """The smallest header of a length ``n``: a fix form up to
    ``fix_max``, else the first ``(code, fmt, max)`` that holds it."""
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt, most in forms:
        if n <= most:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} is too long for msgpack")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v > 0:
        forms = ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF))
        for code, fmt, most in forms:
            if v <= most:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        forms = ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                 (0xD2, ">i", 0x80000000), (0xD3, ">q", 0x8000000000000000))
        for code, fmt, most in forms:
            if -v <= most:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit in 64 bits")


def _pack(obj, out: list) -> None:
    # bool before int: a bool is an int to isinstance
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xA0, 31, _STR) + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_header(len(data), 0, -1, _BIN) + data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, _ARRAY))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def dumps(obj) -> bytes:
    """``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` writes it."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class Reader:
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

    def ext(self, code: int, data: bytes):
        raise ValueError(f"msgpack ext type {code} has no reader here")

    def whole(self):
        """The one object that the data holds; raises on bytes after it."""
        out = self.read()
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} bytes after the "
                             "msgpack object")
        return out


def loads(data: bytes):
    """The object that the msgpack ``data`` holds, as
    ``msgpack.unpackb(data, raw=False)`` reads it."""
    return Reader(data).whole()
