"""A reader of the msgpack files that the JAX package's ``save_checkpoint``
writes (``flax.serialization.msgpack_serialize``), in plain Python: the
port's machine need have neither ``msgpack`` nor ``flax``.

It decodes every msgpack type (maps, arrays, str, bin, ints, floats, bool,
nil, ext) and flax's ext types: 1 is an ndarray, packed as the msgpack array
``(shape, dtype name, C-order bytes)``; 2 a complex, packed as
``(real, imag)``; 3 a numpy scalar, packed as a 0-d ndarray. Leaves over
flax's ``MAX_CHUNK_SIZE`` (2**30 bytes) were written as chunked-array maps
(``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``) and
come back as one array, as ``msgpack_restore`` returns them. Arrays are
numpy, each a writable copy; bfloat16 comes back as a torch tensor (numpy has
no such type).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw_str=False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw_str)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw_str)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw_str)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n, raw_str)
            if kind == "array":
                return self.array(n, raw_str)
            if kind == "map":
                return self.map(n, raw_str)
            return self.ext(self.unpack(">b"), n)
        if b in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[b])
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def str(self, n, raw_str):
        data = bytes(self.take(n))
        return data if raw_str else data.decode("utf-8")

    def array(self, n, raw_str):
        return [self.obj(raw_str) for _ in range(n)]

    def map(self, n, raw_str):
        out = {}
        for _ in range(n):
            key = self.obj(raw_str)
            out[key] = self.obj(raw_str)
        return out

    def ext(self, code, n):
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one that flax writes")


_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def _ndarray(data):
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``, the
    strings read raw as flax reads them."""
    reader = _Reader(data)
    shape, dtype_name, buffer = reader.obj(raw_str=True)
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after an ndarray")
    dtype_name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if dtype_name == "bfloat16":
        raw = np.frombuffer(buffer, dtype=np.uint16).copy()
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``, for a whole tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data):
    """One msgpack object from ``data`` (bytes), which it must fill."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack object")
    return out


def msgpack_restore(data):
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``: dicts (lists were written as maps keyed '0', '1', ...), numpy
    arrays and scalars, Python numbers, strings, bools and None."""
    return _unchunk(unpackb(data))
