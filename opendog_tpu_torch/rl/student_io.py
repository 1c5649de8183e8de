"""Reader of the students that the JAX package saves (``student.msgpack``).

The JAX package writes a student's parameters with
``flax.serialization.to_bytes``: msgpack maps of strings, each array an
ext of type 1 whose data is itself msgpack, ``[shape, dtype name, bytes]``
in C order.  This module decodes that format in plain Python (the msgpack
reader of ``telemetry/wire.py`` with flax's ext types) into the
nested dict of numpy arrays that ``flax.serialization.msgpack_restore``
returns, so the committed students load where neither msgpack nor flax is
installed.  It reads; it does not write.
"""
from __future__ import annotations

import numpy as np

from ..telemetry.wire import Reader

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader(Reader):
    """The msgpack decoder with flax's ext types."""

    def ext(self, code: int, data: bytes):
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
    return _Reader(data).whole()


def load_params(path: str) -> dict:
    """The parameter tree of a saved student: ``{"params": {"Dense_0":
    {"kernel": ..., "bias": ...}, ..., "log_std": ...}}`` of numpy
    arrays."""
    with open(path, "rb") as f:
        return loads(f.read())
