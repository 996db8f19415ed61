"""The data axis: the default process group, and its two collectives.

Port of the ``data`` axis of ``ssrl_vit_mae_jepa_tpu/parallel/mesh.py``.
The JAX package runs its step as ``shard_map`` over a (data, model) mesh
and ``psum``s over ``data``; here each rank is one process on one card, the
axis is the default process group, and the ``psum`` is an ``all_reduce``
by sum. Only ``all_reduce`` and ``broadcast`` are used: they are the
collectives that ``gloo`` takes on CUDA tensors as well as ``nccl``, so two
ranks can share one card. Each call moves one flat buffer.

Not ported: the JAX ``model`` axis, the tensor-parallel rules
``_TP_RULES`` that GSPMD partitions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ssrl_vit_mae_jepa_torch.parallel.multihost import is_initialized


@dataclass(frozen=True)
class DataAxis:
    """The ranks a step's batch is split over: ``size`` ranks, this one
    ``rank``."""
    size: int
    rank: int


def get_data_axis() -> Optional[DataAxis]:
    """The default process group as the data axis; None without a group."""
    if not is_initialized():
        return None
    return DataAxis(dist.get_world_size(), dist.get_rank())


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over every rank of ``tensors`` (one dtype, one device), as
    new tensors, through one ``all_reduce``."""
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return _unflat(flat, tensors)


def broadcast_from(tensors: Sequence[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Rank ``src``'s values of ``tensors`` on every rank, as new tensors,
    through one ``broadcast``."""
    flat = _flat(tensors)
    dist.broadcast(flat, src=src)
    return _unflat(flat, tensors)
