"""A reader of the JAX package's ``state.msgpack``, without msgpack or flax.

The JAX package's native checkpoints (``ssrl_vit_mae_jepa_tpu/utils/
checkpoint.py::save_checkpoint``) hold the train state as
``flax.serialization.to_bytes`` writes it: MessagePack with three extension
types (``flax/serialization.py::_msgpack_ext_pack``):

- ext 1, an ndarray: an inner MessagePack array ``(shape, dtype name,
  C-order bytes)`` (``_ndarray_to_bytes``);
- ext 2, a Python complex: an inner ``(real, imag)``;
- ext 3, a numpy scalar: an ndarray of shape ``()``;

and arrays above 1 GiB cut into ``{"__msgpack_chunked_array__": True,
"shape": {...}, "chunks": {...}}`` maps (``_chunk``). This module decodes
that subset of MessagePack (maps, arrays, str, bin, int, float, nil, bool
and those extensions) in pure Python and returns the tree with every array
as a CPU ``torch.Tensor`` (a numpy scalar as a 0-d tensor). ``bfloat16``
buffers are read with ``torch.frombuffer``, so numpy needs no bf16 type.
"""

from __future__ import annotations

import json
import struct
import zipfile
from typing import Any, Tuple

import torch

_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64, "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
#: the ``__format__`` of the JAX package's ``meta.json``
NATIVE_FORMAT = "ssrl_vit_mae_jepa_tpu"


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        #: str as bytes, as flax's inner ndarray decoding asks (``raw=True``)
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"MessagePack type byte 0x{b:02x} is not written by flax")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data).reshape(())
        if code == _EXT_COMPLEX:
            re, im = _decode(data)
            return complex(re, im)
        raise ValueError(f"MessagePack extension type {code} is not written by flax")


def _decode(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after the MessagePack value")
    return out


def _ndarray(data: bytes) -> torch.Tensor:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, C-order bytes)``."""
    shape, name, buf = _decode(data, raw=True)
    name = name.decode("ascii")
    if name not in _DTYPES:
        raise ValueError(f"array dtype {name!r} is not supported")
    dtype = _DTYPES[name]
    shape = tuple(int(s) for s in shape)
    if not buf:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)


def _unchunk(node: dict) -> torch.Tensor:
    shape = tuple(int(node["shape"][str(i)]) for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    return torch.cat(chunks).reshape(shape)


def _restore_chunks(node: Any) -> Any:
    if isinstance(node, dict):
        if _CHUNKED in node:
            return _unchunk(node)
        return {k: _restore_chunks(v) for k, v in node.items()}
    return node


def msgpack_restore(blob: bytes) -> Any:
    """The tree of ``flax.serialization.msgpack_restore(blob)``: nested
    dicts (lists for MessagePack arrays), tensors for arrays and numpy
    scalars, Python values for the rest."""
    return _restore_chunks(_decode(blob))


def is_native_zip(path) -> bool:
    """A zip holding ``meta.json`` and ``state.msgpack``: the layout of the
    JAX package's native checkpoints, whatever its ``__format__`` says."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            return {"meta.json", "state.msgpack"} <= set(zf.namelist())
    except (zipfile.BadZipFile, OSError):
        return False


def read_native_checkpoint(path) -> Tuple[Any, dict]:
    """A JAX-native checkpoint → (state tree, meta): the zip's
    ``state.msgpack`` decoded and its ``meta.json``. A ``__format__`` other
    than the JAX package's raises, as its ``load_checkpoint`` does."""
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta.get("__format__") != NATIVE_FORMAT:
            raise ValueError(f"{path} is not a {NATIVE_FORMAT} checkpoint")
        blob = zf.read("state.msgpack")
    return msgpack_restore(blob), meta
