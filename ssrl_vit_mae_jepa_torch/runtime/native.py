"""ctypes binding of the host gather (``batch_gather.cpp``), with a numpy
fallback.

The port's own copy of ``ssrl_vit_mae_jepa_tpu/runtime/native.py``. The
source is built with ``g++`` on first use into ``build/native/`` beside the
package (a path ``.gitignore`` lists), named by a hash of the source, and
renamed into place atomically so concurrent builds are safe. Without a
compiler, or with ``SSRL_DISABLE_NATIVE=1`` (read at the first call),
:func:`gather_nhwc` takes the numpy path, as the JAX package's does. This is
host code, not a kernel of the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "batch_gather.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CMD = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_CMD).encode()).hexdigest()[:16]
    return BUILD_DIR / f"_batch_gather_{h}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".so", dir=so.parent, delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        subprocess.run([*_CMD, str(_SRC), "-o", str(tmp_path)], check=True,
                       capture_output=True)
        os.replace(tmp_path, so)
        return True
    except (OSError, subprocess.CalledProcessError):
        tmp_path.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("SSRL_DISABLE_NATIVE") == "1":
        return None
    so = _so_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.gather_nhwc.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.gather_nhwc.restype = None
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def gather_nhwc(raw: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(N, C, W, H) uint8 raw + (B,) indices → (B, H, W, C) uint8, through
    the native gather (up to 8 threads) when it is built, numpy otherwise."""
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    N, C, W, H = raw.shape
    B = len(indices)
    # the C gather does raw pointer arithmetic: fail as numpy would
    if B and (indices.min() < 0 or indices.max() >= N):
        raise IndexError(
            f"gather_nhwc indices out of range [0, {N}): "
            f"min={indices.min()}, max={indices.max()}"
        )
    lib = _load()
    if lib is None:
        batch = np.asarray(raw[indices])  # (B, C, W, H)
        return np.ascontiguousarray(batch.transpose(0, 3, 2, 1))
    out = np.empty((B, H, W, C), np.uint8)
    if not raw.flags["C_CONTIGUOUS"]:
        raw = np.ascontiguousarray(raw)
    lib.gather_nhwc(
        raw.ctypes.data_as(ctypes.c_void_p), indices.ctypes.data,
        B, N, C, W, H, out.ctypes.data, min(8, os.cpu_count() or 1),
    )
    return out
