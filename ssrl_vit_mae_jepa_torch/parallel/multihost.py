"""Multi-process bootstrap and per-process index shards.

Port of ``ssrl_vit_mae_jepa_tpu/parallel/multihost.py``. PyTorch runs one
process per card, which is the JAX package's multi-process path: each
process feeds its own contiguous shard of the epoch's indices at
``batch_size // world`` rows (``data/loaders.py``) and keeps its batch on
its own card, so nothing assembles a global array (the JAX
``global_batch``); the steps all-reduce what the JAX steps ``psum``
(``training/tasks.py``).

- ``maybe_initialize_distributed()``: the process group from the JAX
  package's ``SSRL_COORDINATOR`` / ``SSRL_NUM_PROCESSES`` /
  ``SSRL_PROCESS_ID``, or from PyTorch's own ``MASTER_ADDR`` / ``RANK`` /
  ``WORLD_SIZE`` (what ``python -m torch.distributed.run`` sets); ``nccl``
  on the card (the default: with no card it raises), ``gloo`` on the CPU
  when the caller asks for it;
- ``process_local_indices``: the contiguous per-process shard, padded by
  wrap-around, as the JAX function pads it;
- the process's rank, the world size and its card, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, the one process that writes files."""
    return rank() == 0


def local_rank() -> int:
    """The process's index among those of its host: ``$LOCAL_RANK`` (set by
    ``torch.distributed.run``), else the rank modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() % max(1, torch.cuda.device_count())


def maybe_initialize_distributed(device_type: Optional[str] = None,
                                 backend: Optional[str] = None) -> bool:
    """Join the default process group when the environment configures one;
    returns whether a group is up.

    ``device_type`` is where the process trains (``"cuda"``, the default,
    or ``"cpu"``): on ``"cuda"`` the process takes the card
    ``cuda:LOCAL_RANK`` and the group ``nccl``, on the CPU ``gloo``. With
    no card visible ``"cuda"`` raises before any group is created: a caller
    that wants the CPU says so. ``backend`` overrides the choice of
    backend (two processes that share one card need ``gloo``: ``nccl``
    refuses two ranks on one device)."""
    if is_initialized():
        return True
    coord = os.environ.get("SSRL_COORDINATOR")
    if coord:
        init_method = f"tcp://{coord}"
        world = int(os.environ.get("SSRL_NUM_PROCESSES", "1"))
        rank_ = int(os.environ.get("SSRL_PROCESS_ID", "0"))
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
        init_method = "env://"
        world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the process group would train on the card; pass "
            "device_type='cpu' to join it on the CPU")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank_ % max(1, torch.cuda.device_count()))))
    dist.init_process_group(backend or ("nccl" if device_type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank_)
    return True


def process_local_indices(indices: np.ndarray, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    """Contiguous per-process shard of an index array, padded to equal size
    by wrap-around so that every process sees the same number of batches."""
    pc = process_count if process_count is not None else world_size()
    pi = process_index if process_index is not None else rank()
    if pc == 1:
        return indices
    per = -(-len(indices) // pc)
    padded = np.resize(indices, per * pc)
    return padded[pi * per: (pi + 1) * per]
