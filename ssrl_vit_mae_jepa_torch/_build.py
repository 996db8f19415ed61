"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into an object, one process per source
all started together, and links them into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library is
named by a hash of the sources and flags, built at first use into
``build/torch_kernels/`` beside the package, and loaded with ``ctypes``.
Every entry point returns a ``cudaError_t``; :func:`check` raises on any
code other than 0, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)  # a C array of device pointers
_PI = ctypes.POINTER(ctypes.c_int)  # an int the call writes
# name -> (restype, argtypes); every pointer and the stream are c_void_p, so
# ctypes never narrows a 64-bit address to a 32-bit int
_SIGNATURES = {
    "ssrl_attn_branch_fwd_workspace": (_LL, [_I] * 4),
    "ssrl_attn_branch_fwd": (_I, [_P] * 10 + [_I] * 4 + [_F, _P]),
    "ssrl_attn_branch_bwd_workspace": (_LL, [_I] * 3),
    "ssrl_attn_branch_bwd": (_I, [_P] * 14 + [_I] * 4 + [_F, _P]),
    "ssrl_mlp_branch_fwd_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_fwd": (_I, [_P] * 9 + [_I] * 3 + [_P]),
    "ssrl_mlp_branch_bwd_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_bwd": (_I, [_P] * 13 + [_I] * 3 + [_P]),
    # the branches split over a model axis (csrc/attn_branch.cu,
    # csrc/mlp_branch.cu, csrc/branch_f32.cu): B, L, D, Da[, stash] / M, D, F
    "ssrl_attn_branch_part_fwd_workspace": (_LL, [_I] * 5),
    "ssrl_attn_branch_part_fwd": (_I, [_P] * 9 + [_I] * 5 + [_F, _P]),
    "ssrl_attn_branch_part_bwd_workspace": (_LL, [_I] * 4),
    "ssrl_attn_branch_part_bwd": (_I, [_P] * 13 + [_I] * 5 + [_F, _P]),
    "ssrl_mlp_branch_part_fwd_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_part_fwd": (_I, [_P] * 8 + [_I] * 3 + [_P]),
    "ssrl_mlp_branch_part_bwd_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_part_bwd": (_I, [_P] * 12 + [_I] * 3 + [_P]),
    # x, s, b, out, M, D, stream / x, ln_s, dy, gy, dx, dln3, ws, M, D, stream
    "ssrl_branch_finish": (_I, [_P] * 4 + [_I] * 2 + [_P]),
    "ssrl_branch_ln_bwd_workspace": (_LL, [_I] * 2),
    "ssrl_branch_ln_bwd": (_I, [_P] * 7 + [_I] * 2 + [_P]),
    "ssrl_mha_fits": (_I, [_I] * 2),
    # L, d, bwd -> blocks per SM, warps a block, shared bytes, registers
    "ssrl_mha_occupancy": (_I, [_I] * 3 + [_PI] * 4),
    # pointers, in strides (b, h, row), out strides, B, H, L, d, scale, post, stream
    "ssrl_mha_fwd": (_I, [_P] * 4 + [_LL, _I, _I] * 2 + [_I] * 4 + [_F, _I, _P]),
    "ssrl_mha_bwd": (_I, [_P] * 7 + [_LL, _I, _I] * 2 + [_I] * 4 + [_F, _I, _P]),
    # pointers, B, N, Pc, D, K, stream (a null idx: no gather, K = N + 1)
    "ssrl_patch_embed_fwd": (_I, [_P] * 7 + [_I] * 5 + [_P]),
    "ssrl_patch_embed_bwd_workspace": (_LL, [_I] * 6),
    "ssrl_patch_embed_bwd": (_I, [_P] * 9 + [_I] * 5 + [_P]),
    # x, params (12 per block), out, [stash,] ws, B, L, D, H, F, [N,] scale, stream
    "ssrl_fused_block_fwd_workspace": (_LL, [_I] * 4),
    "ssrl_fused_block_fwd": (_I, [_P, _PP, _P, _P] + [_I] * 5 + [_F, _P]),
    "ssrl_fused_block_bwd_workspace": (_LL, [_I] * 4),
    "ssrl_fused_block_bwd": (_I, [_P, _PP] + [_P] * 4 + [_I] * 5 + [_F, _P]),
    "ssrl_block_chain_fwd_workspace": (_LL, [_I] * 5),
    "ssrl_block_chain_fwd": (_I, [_P, _PP] + [_P] * 3 + [_I] * 6 + [_F, _P]),
    "ssrl_block_chain_bwd_workspace": (_LL, [_I] * 4),
    "ssrl_block_chain_bwd": (_I, [_P, _PP] + [_P] * 5 + [_I] * 6 + [_F, _P]),
    # layout, M, N, K / layout, epi, 11 pointers, M, N, K, stream
    "ssrl_gemm_workspace": (_LL, [_I] * 4),
    "ssrl_gemm": (_I, [_I] * 2 + [_P] * 11 + [_I] * 3 + [_P]),
    # the f32 kernels (csrc/branch_f32.cu, mha_f32.cu, fused_block_f32.cu,
    # block_chain_f32.cu, patch_embed_f32.cu) take the bf16 entries' arguments;
    # the attention core's fit takes L, d and whether the backward must fit too
    "ssrl_attn_f32_fits": (_I, [_I] * 3),
    "ssrl_attn_branch_fwd_f32_workspace": (_LL, [_I] * 4),
    "ssrl_attn_branch_fwd_f32": (_I, [_P] * 10 + [_I] * 4 + [_F, _P]),
    "ssrl_attn_branch_bwd_f32_workspace": (_LL, [_I] * 3),
    "ssrl_attn_branch_bwd_f32": (_I, [_P] * 14 + [_I] * 4 + [_F, _P]),
    "ssrl_mlp_branch_fwd_f32_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_fwd_f32": (_I, [_P] * 9 + [_I] * 3 + [_P]),
    "ssrl_mlp_branch_bwd_f32_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_bwd_f32": (_I, [_P] * 13 + [_I] * 3 + [_P]),
    "ssrl_fused_block_fwd_f32_workspace": (_LL, [_I] * 4),
    "ssrl_fused_block_fwd_f32": (_I, [_P, _PP, _P, _P] + [_I] * 5 + [_F, _P]),
    "ssrl_fused_block_bwd_f32_workspace": (_LL, [_I] * 4),
    "ssrl_fused_block_bwd_f32": (_I, [_P, _PP] + [_P] * 4 + [_I] * 5 + [_F, _P]),
    "ssrl_block_chain_fwd_f32_workspace": (_LL, [_I] * 5),
    "ssrl_block_chain_fwd_f32": (_I, [_P, _PP] + [_P] * 3 + [_I] * 6 + [_F, _P]),
    "ssrl_block_chain_bwd_f32_workspace": (_LL, [_I] * 4),
    "ssrl_block_chain_bwd_f32": (_I, [_P, _PP] + [_P] * 5 + [_I] * 6 + [_F, _P]),
    "ssrl_patch_embed_fwd_f32": (_I, [_P] * 7 + [_I] * 5 + [_P]),
    "ssrl_patch_embed_bwd_f32_workspace": (_LL, [_I] * 6),
    "ssrl_patch_embed_bwd_f32": (_I, [_P] * 9 + [_I] * 5 + [_P]),
    "ssrl_mha_f32_fwd": (_I, [_P] * 4 + [_LL, _I, _I] * 2 + [_I] * 4 + [_F, _I, _P]),
    "ssrl_mha_f32_bwd": (_I, [_P] * 7 + [_LL, _I, _I] * 2 + [_I] * 4 + [_F, _I, _P]),
    "ssrl_mha_f32_occupancy": (_I, [_I] * 3 + [_PI] * 4),
    # the f32 branch GEMM alone: layout, M, N, K / layout, epi, 9 pointers,
    # M, N, K, stream
    "ssrl_gemm_f32_workspace": (_LL, [_I] * 4),
    "ssrl_gemm_f32": (_I, [_I] * 2 + [_P] * 9 + [_I] * 3 + [_P]),
    "ssrl_attn_branch_part_fwd_f32_workspace": (_LL, [_I] * 5),
    "ssrl_attn_branch_part_fwd_f32": (_I, [_P] * 9 + [_I] * 5 + [_F, _P]),
    "ssrl_attn_branch_part_bwd_f32_workspace": (_LL, [_I] * 4),
    "ssrl_attn_branch_part_bwd_f32": (_I, [_P] * 13 + [_I] * 5 + [_F, _P]),
    "ssrl_mlp_branch_part_fwd_f32_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_part_fwd_f32": (_I, [_P] * 8 + [_I] * 3 + [_P]),
    "ssrl_mlp_branch_part_bwd_f32_workspace": (_LL, [_I] * 3),
    "ssrl_mlp_branch_part_bwd_f32": (_I, [_P] * 12 + [_I] * 3 + [_P]),
    "ssrl_branch_finish_f32": (_I, [_P] * 4 + [_I] * 2 + [_P]),
    "ssrl_branch_ln_bwd_f32_workspace": (_LL, [_I] * 2),
    "ssrl_branch_ln_bwd_f32": (_I, [_P] * 7 + [_I] * 2 + [_P]),
    "ssrl_error_string": (ctypes.c_char_p, [_I]),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libssrl_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "the CUDA kernels need nvcc: install the CUDA toolkit or set CUDA_HOME"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc exited with {p.returncode}:\n{' '.join(cmd)}\n{err}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{p.stem}.o" for p in sources() if p.suffix == ".cu"]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(_CSRC / f"{o.stem}.cu"), "-o", str(o)]
                  for o in objs])
        tmp = Path(tmpdir) / out.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and typed from _SIGNATURES."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = load().ssrl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
