"""A reader and a writer of the JAX package's ``state.msgpack``, without
msgpack or flax.

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

The writer, :func:`msgpack_serialize`, packs the subset that
``flax.serialization.to_bytes`` writes for a tree of dicts and numpy arrays
(maps, arrays as ext 1, str, bin, int, float, nil and bool) with msgpack's
smallest encodings, so the bytes equal flax's; it does not cut arrays above
1 GiB into chunks and refuses them.
:func:`write_native_checkpoint` writes the zip as the JAX package's
``save_checkpoint`` does.
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
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
#: the ``__format__`` and ``__version__`` of the JAX package's ``meta.json``
NATIVE_FORMAT = "ssrl_vit_mae_jepa_tpu"
NATIVE_VERSION = 1
#: flax's ``MAX_CHUNK_SIZE``: larger arrays are written in chunks
MAX_CHUNK_BYTES = 2**30


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


def _sized(out: bytearray, n: int, small: Optional[Tuple[int, int]], codes, limit: str) -> None:
    """A length header: the fix form ``small = (base, max)`` where it fits,
    else the 8-, 16- or 32-bit form ``codes`` (None where msgpack has none)."""
    if small is not None and n <= small[1]:
        out.append(small[0] | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"{limit} of {n} is too long for MessagePack")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2**64 - 1)) if v >= 0 else (
        (0xD0, ">b", -2**7, 0), (0xD1, ">h", -2**15, 0), (0xD2, ">i", -2**31, 0),
        (0xD3, ">q", -2**63, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} does not fit in 64 bits")


def _array_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, C-order bytes)``."""
    if arr.dtype.name not in _DTYPES:
        raise ValueError(f"array dtype {arr.dtype} is not supported")
    if arr.nbytes > MAX_CHUNK_BYTES:
        raise ValueError(f"an array of {arr.nbytes} bytes: flax writes arrays above "
                         f"{MAX_CHUNK_BYTES} bytes in chunks, which this writer does not")
    return msgpack_serialize([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _sized(out, len(data), None, (0xC7, 0xC8, 0xC9), "an extension")
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, v: Any) -> None:
    # exact types, as flax's packer (``strict_types=True``) takes them: a
    # numpy scalar (np.float64 is a float subclass) is refused, not cast
    t = type(v)
    if v is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if v else 0xC2)
    elif t is int:
        _int(out, v)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif t is str:
        b = v.encode("utf-8")
        _sized(out, len(b), (0xA0, 0x1F), (0xD9, 0xDA, 0xDB), "a string")
        out += b
    elif t is bytes:
        _sized(out, len(v), None, (0xC4, 0xC5, 0xC6), "a byte string")
        out += v
    elif t is np.ndarray:
        _ext(out, _EXT_NDARRAY, _array_payload(v))
    elif t is dict:
        _sized(out, len(v), (0x80, 0x0F), (None, 0xDE, 0xDF), "a map")
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif t is list:
        _sized(out, len(v), (0x90, 0x0F), (None, 0xDC, 0xDD), "an array")
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"{t.__name__} is not written by this MessagePack writer")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree
    of dicts (packed in their order) with numpy array leaves and Python
    values (None, bool, int, float, str, bytes, lists)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def _sorted_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def write_native_checkpoint(path, tree: dict, meta: Optional[dict] = None) -> Path:
    """Atomically write ``tree`` as a JAX-native checkpoint: a ``ZIP_STORED``
    zip of ``state.msgpack`` and ``meta.json`` (``meta`` with the JAX
    package's ``__format__`` and ``__version__``), byte for byte the file of
    ``ssrl_vit_mae_jepa_tpu/utils/checkpoint.py::save_checkpoint``. That
    function first maps the tree through ``jax.tree.map``, which rebuilds
    every dict in sorted key order, so the maps are packed sorted here."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {**(meta or {}), "__format__": NATIVE_FORMAT, "__version__": NATIVE_VERSION}
    blob = msgpack_serialize(_sorted_tree(tree))
    tmp = path.with_suffix(path.suffix + ".tmp")
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("state.msgpack", blob)
        zf.writestr("meta.json", json.dumps(meta))
    os.replace(tmp, path)
    return path
