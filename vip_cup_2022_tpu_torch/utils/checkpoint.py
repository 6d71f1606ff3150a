"""Read the JAX package's msgpack checkpoints with numpy alone.

Counterpart of ``vip_cup_2022_tpu/utils/checkpoint.py::load_variables``: the
payload's md5 is checked against the ``<path>.md5`` sidecar when one exists,
then the bytes are decoded. ``flax.serialization.to_bytes`` writes a
msgpack map tree whose array leaves are ext type 1, each holding a
msgpack-packed ``(shape, dtype name, C-order bytes)`` triple; numpy scalars
are ext type 3 in the same form. Arrays over
2**30 bytes are split into a ``__msgpack_chunked_array__`` map. This module
decodes exactly that subset of msgpack, so the port needs neither ``msgpack``
nor ``flax``.
"""
from __future__ import annotations

import hashlib
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """Decoder of one msgpack buffer. ``raw`` keeps str payloads as bytes,
    as flax's inner array triples are packed."""

    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if t in sized:
            kind, fmt = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str_(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map_(n)
            return self.ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        raise ValueError(f"msgpack ext type {code} is not supported")


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object that fills ``data``."""
    reader = _Reader(data, raw=raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after msgpack object")
    return out


def _bfloat16_to_float32(buffer: bytes) -> np.ndarray:
    """bf16 is the top half of an f32: widening is exact."""
    bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
    return bits.view(np.float32)


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        arr = _bfloat16_to_float32(buffer)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(name))
    return arr.reshape(tuple(shape), order="C")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = _tuple_of(tree["shape"])
        return np.concatenate(_tuple_of(tree["chunks"])).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _tuple_of(d: Dict[str, Any]) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def msgpack_restore(data: bytes) -> Any:
    """Counterpart of ``flax.serialization.msgpack_restore``: the pytree of
    dicts with numpy array leaves (bfloat16 leaves widened to float32)."""
    return _unchunk(unpackb(data))


def load_variables(path: str, verify: bool = True) -> Any:
    """Restore a variables tree; when ``<path>.md5`` exists the payload digest
    is verified first and a mismatch raises."""
    with open(path, "rb") as fh:
        data = fh.read()
    sidecar = path + ".md5"
    if verify and os.path.isfile(sidecar):
        with open(sidecar) as fh:
            expected = fh.read().split()[0].strip()
        actual = hashlib.md5(data).hexdigest()
        if actual != expected:
            raise ValueError(
                f"checksum mismatch for {path}: md5 {actual} != recorded "
                f"{expected} (sidecar {sidecar}); the checkpoint is corrupt "
                "or was modified without updating its sidecar")
    return msgpack_restore(data)
