"""Read and write the JAX package's msgpack checkpoints with numpy alone.

Counterpart of ``vip_cup_2022_tpu/utils/checkpoint.py``'s ``load_variables``
and ``save_variables``: a load checks the payload's md5 against the
``<path>.md5`` sidecar when one exists, then decodes the bytes; a save
writes the bytes and the sidecar. ``flax.serialization.to_bytes`` writes a
msgpack map tree whose array leaves are ext type 1, each holding a
msgpack-packed ``(shape, dtype name, C-order bytes)`` triple; numpy scalars
are ext type 3 in the same form. Arrays over
2**30 bytes are split into a ``__msgpack_chunked_array__`` map. This module
encodes and decodes exactly that subset of msgpack, so the port needs
neither ``msgpack`` nor ``flax``.
"""
from __future__ import annotations

import hashlib
import os
import struct
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

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


MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization's: bigger arrays are written in chunks


class _RawArray(NamedTuple):
    """An array leaf as the writer records it: shape, dtype name, C-order
    bytes (a bf16 tensor's bits under the name ``bfloat16``, as JAX writes
    its bf16 arrays)."""

    shape: Tuple[int, ...]
    dtype_name: str
    data: bytes


class _Writer:
    """msgpack-python's encoding (``strict_types``, ``use_bin_type``) of the
    types a checkpoint holds: the smallest header for each int, str, bin,
    map, array and ext, floats as float64; numpy scalars are not Python
    numbers here, as under ``strict_types``."""

    def __init__(self):
        self.parts = []

    def put(self, fmt: str, *values) -> None:
        self.parts.append(struct.pack(fmt, *values))

    def header(self, n: int, fix: Optional[int], fix_max: int, codes: Tuple) -> None:
        if fix is not None and n <= fix_max:
            self.put(">B", fix | n)
        elif n <= 0xFF and codes[0] is not None:
            self.put(">BB", codes[0], n)
        elif n <= 0xFFFF:
            self.put(">BH", codes[1], n)
        else:
            self.put(">BI", codes[2], n)

    def value(self, obj: Any) -> None:
        kind = type(obj)
        if obj is None:
            self.put(">B", 0xC0)
        elif kind is bool:
            self.put(">B", 0xC3 if obj else 0xC2)
        elif kind is int:
            self.int_(obj)
        elif kind is float:
            self.put(">Bd", 0xCB, obj)
        elif kind is str:
            data = obj.encode("utf-8")
            self.header(len(data), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
            self.parts.append(data)
        elif kind is bytes:
            self.header(len(obj), None, 0, (0xC4, 0xC5, 0xC6))
            self.parts.append(obj)
        elif kind in (list, tuple):
            self.header(len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
            for v in obj:
                self.value(v)
        elif kind is dict:
            self.header(len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
            for k, v in obj.items():
                self.value(k)
                self.value(v)
        elif kind is _RawArray:
            self.ext(_EXT_NDARRAY, _packb((list(obj.shape), obj.dtype_name, obj.data)))
        elif isinstance(obj, np.ndarray):
            self.value(_RawArray(obj.shape, obj.dtype.name, obj.tobytes("C")))
        elif isinstance(obj, np.generic):
            arr = np.asarray(obj)
            self.ext(_EXT_NPSCALAR, _packb((list(arr.shape), arr.dtype.name, arr.tobytes("C"))))
        else:
            raise TypeError(f"a checkpoint cannot hold a {kind.__name__}")

    def int_(self, n: int) -> None:
        if 0 <= n < 0x80 or -0x20 <= n < 0:
            self.put(">b" if n < 0 else ">B", n)
            return
        for lo, hi, code, fmt in ((0, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"),
                                  (0, 0xFFFF, 0xCD, "H"), (-0x8000, -1, 0xD1, "h"),
                                  (0, 0xFFFFFFFF, 0xCE, "I"), (-0x80000000, -1, 0xD2, "i"),
                                  (0, 0xFFFFFFFFFFFFFFFF, 0xCF, "Q"),
                                  (-0x8000000000000000, -1, 0xD3, "q")):
            if lo <= n <= hi:
                self.put(">B" + fmt, code, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack")

    def ext(self, code: int, data: bytes) -> None:
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixext:
            self.put(">B", fixext[len(data)])
        else:
            self.header(len(data), None, 0, (0xC7, 0xC8, 0xC9))
        self.put(">b", code)
        self.parts.append(data)


def _packb(obj: Any) -> bytes:
    """Encode one object as msgpack, as ``msgpack.packb(obj,
    use_bin_type=True, strict_types=True)`` does for the types of
    :class:`_Writer`."""
    writer = _Writer()
    writer.value(obj)
    return b"".join(writer.parts)


def _state_dict(tree: Any) -> Any:
    """Flax's state dict of a tree: str keys, lists and tuples as maps keyed
    "0", "1", ..., torch tensors as array leaves, arrays over
    :data:`MAX_CHUNK_SIZE` bytes in chunks."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError("dict keys do not have a unique string form")
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        if t.dtype != torch.bfloat16:
            return _state_dict(t.numpy())
        if t.numel() * 2 > MAX_CHUNK_SIZE:
            raise ValueError("a bf16 tensor over 2**30 bytes is not written; cast it to f32")
        return _RawArray(tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes())
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts, lists, numpy or
    torch arrays and Python scalars."""
    return _packb(_state_dict(tree))


def save_variables(path: str, variables: Any, checksum: bool = True) -> Optional[str]:
    """Write ``variables`` as the JAX package's ``save_variables`` does: the
    msgpack bytes, and an ``<path>.md5`` sidecar unless ``checksum`` is
    False. Returns the hex digest (None without a sidecar)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = to_bytes(variables)
    with open(path, "wb") as fh:
        fh.write(data)
    if not checksum:
        return None
    digest = hashlib.md5(data).hexdigest()
    with open(path + ".md5", "w") as fh:
        fh.write(f"{digest}  {os.path.basename(path)}\n")
    return digest
