"""The (data, model) process grid: its groups, its collectives, and the
Megatron layout of the parameters over the model axis.

Port of ``ssrl_vit_mae_jepa_tpu/parallel/mesh.py``. The JAX package runs
its step as ``shard_map`` over a (data, model) mesh, ``psum``s over
``data`` and leaves ``model`` to GSPMD under ``_TP_RULES``. Here each rank
is one process on one card, and the grid is the default process group cut
as the JAX mesh's ``reshape(n // mp, mp)``: rank ``r = d·mp + m`` is data
rank ``d`` and model rank ``m``. ``get_mesh`` builds one group per data
column (the ranks of one ``m``: the gradients' all-reduce) and one per
model row (the ranks of one ``d``: the blocks' all-reduces,
``parallel/tensor.py`` and ``ops/block_fused.py``). With
``model_parallel=1`` the data axis is the default group itself, the
data-parallel path of earlier releases.

The model axis shards by heads, not by the JAX rules' contiguous column
halves of qkv (under GSPMD a storage annotation only): model rank ``m``
holds the q, k and v rows of heads ``[m·H/mp, (m+1)·H/mp)`` of
``qkv.weight`` (3D × D, rows q | k | v, each by head) and their bias, the
columns of those heads of ``proj.weight``, and the ``m``-th F/mp slice of
``fc1`` (rows, and bias) and ``fc2`` (columns), so its attention is local.
Everything else is replicated, as the JAX rules leave it (norms,
embeddings, the ``proj`` and ``fc2`` biases, heads and projections). The
storage differs from the JAX package's; the results do not. Checkpoints
hold full tensors (``gather_params``).

Only ``all_reduce`` and ``broadcast`` are used: they are the collectives
that ``gloo`` takes on CUDA tensors as well as ``nccl``, so two ranks can
share one card. A gather is an ``all_reduce`` of a zero-filled full buffer
into which each rank has written its slice. Each call moves one flat
buffer.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from ssrl_vit_mae_jepa_torch.parallel import multihost
from ssrl_vit_mae_jepa_torch.parallel.multihost import is_initialized


@dataclass(frozen=True)
class DataAxis:
    """The ranks a step's batch is split over: ``size`` ranks, this one
    ``rank``, their ``group`` (None: the default group)."""
    size: int
    rank: int
    group: Optional[dist.ProcessGroup] = None


@dataclass(frozen=True)
class ModelAxis:
    """The ranks a block's heads and hidden units are split over: ``size``
    ranks (``model_parallel``), this one ``rank``, their ``group``."""
    size: int
    rank: int
    group: Optional[dist.ProcessGroup] = None


@dataclass(frozen=True)
class Grid:
    """The (data, model) grid of this process: ``data`` None without a
    process group, ``model`` None without a model axis larger than 1."""
    data: Optional[DataAxis] = None
    model: Optional[ModelAxis] = None

    @property
    def shape(self) -> Dict[str, int]:
        """{"data": n // mp, "model": mp}, as the JAX ``Mesh.shape``."""
        return {"data": 1 if self.data is None else self.data.size,
                "model": 1 if self.model is None else self.model.size}


def get_data_axis() -> Optional[DataAxis]:
    """The default process group as the data axis; None without a group."""
    if not is_initialized():
        return None
    return DataAxis(dist.get_world_size(), dist.get_rank())


# (the default group, world, mp) -> (data groups by m, model groups by d)
_GROUPS: Dict[tuple, tuple] = {}


def get_mesh(num_devices: Optional[int] = None, model_parallel: int = 1) -> Grid:
    """The (data, model) grid over the default process group (``get_mesh``
    of the JAX package): rank ``d·mp + m`` at data rank ``d`` of ``n // mp``
    and model rank ``m`` of ``mp``. ``num_devices`` must be the world size
    where given (a process drives one card). Every rank makes every group,
    in one order, on its first call; later calls reuse them. It also tells
    the loaders to shard by data rank (``multihost.set_model_parallel``), so
    the ``mp`` ranks of one model row read the same rows: make the grid
    before the loaders."""
    n = multihost.world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"num_devices={num_devices}, but the process group has {n} ranks "
                         f"(one process drives one card)")
    mp = int(model_parallel)
    if mp < 1 or n % mp:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    multihost.set_model_parallel(mp)
    if not is_initialized():
        return Grid()
    r = dist.get_rank()
    if mp == 1:
        return Grid(DataAxis(n, r), None)
    key = (id(dist.group.WORLD), n, mp)
    if key not in _GROUPS:
        data = [dist.new_group(list(range(m, n, mp))) for m in range(mp)]
        model = [dist.new_group(list(range(d * mp, (d + 1) * mp))) for d in range(n // mp)]
        _GROUPS[key] = (data, model)
    data, model = _GROUPS[key]
    d, m = divmod(r, mp)
    return Grid(DataAxis(n // mp, d, data[m]), ModelAxis(mp, m, model[d]))


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   group: Optional[dist.ProcessGroup] = None) -> List[torch.Tensor]:
    """The sums over every rank of ``group`` (the default group: None) of
    ``tensors`` (one dtype, one device), as new tensors, through one
    ``all_reduce``."""
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return _unflat(flat, tensors)


def broadcast_from(tensors: Sequence[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Rank ``src``'s values of ``tensors`` on every rank, as new tensors,
    through one ``broadcast``."""
    flat = _flat(tensors)
    dist.broadcast(flat, src=src)
    return _unflat(flat, tensors)


# ---------------------------------------------------------------------------
# The Megatron layout over the model axis
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardSpec:
    """A tensor split over the model axis along ``dim``: cut into
    ``chunks`` equal parts (3 for qkv: q | k | v), each part split in
    ``mp`` contiguous slices; rank ``m`` holds the ``m``-th slice of each
    part, in order."""
    dim: int
    chunks: int = 1


# timm names (any prefix: ``encoder.blocks.0.``, ``decoder.decoder_blocks.1.``,
# the EMA target's ``blocks.0.``) -> how the tensor is split; the JAX
# package's _TP_RULES (mesh.py:61-65) over the same four layers
_TP_RULES = [
    (re.compile(r"(^|\.)attn\.qkv\.(weight|bias)$"), ShardSpec(0, 3)),  # column-parallel
    (re.compile(r"(^|\.)attn\.proj\.weight$"), ShardSpec(1)),           # row-parallel
    (re.compile(r"(^|\.)mlp\.fc1\.(weight|bias)$"), ShardSpec(0)),
    (re.compile(r"(^|\.)mlp\.fc2\.weight$"), ShardSpec(1)),
]


def shard_spec(name: str) -> Optional[ShardSpec]:
    """How the tensor named ``name`` is split over a model axis; None where
    it is replicated."""
    for rule, spec in _TP_RULES:
        if rule.search(name):
            return spec
    return None


def param_shardings(names: Iterable[str], model_parallel: int = 1
                    ) -> Dict[str, Optional[ShardSpec]]:
    """name -> ``ShardSpec`` (None: replicated) for each of ``names``;
    every name is replicated without a model axis larger than 1."""
    return {n: shard_spec(n) if model_parallel > 1 else None for n in names}


def shard_index(spec: ShardSpec, full: int, mp: int, m: int) -> torch.Tensor:
    """The indices along ``spec.dim`` (of ``full``) that rank ``m`` of
    ``mp`` holds."""
    if full % (spec.chunks * mp):
        raise ValueError(f"a dim of {full} does not split into {spec.chunks} x {mp} parts")
    per = full // spec.chunks
    part = per // mp
    return torch.cat([torch.arange(c * per + m * part, c * per + (m + 1) * part)
                      for c in range(spec.chunks)])


def shard_tensor(t: torch.Tensor, spec: Optional[ShardSpec], axis: Optional[ModelAxis]
                 ) -> torch.Tensor:
    """Rank ``axis.rank``'s slice of the full tensor ``t`` (a copy), or
    ``t`` itself where it is replicated."""
    if spec is None or axis is None or axis.size == 1:
        return t
    idx = shard_index(spec, t.shape[spec.dim], axis.size, axis.rank).to(t.device)
    return t.index_select(spec.dim, idx).contiguous()


def shard_params(tensors: Mapping[str, torch.Tensor], axis: Optional[ModelAxis]
                 ) -> Dict[str, torch.Tensor]:
    """Full tensors by name -> this rank's tensors (slices of the split
    ones, the replicated ones as they are)."""
    return {k: shard_tensor(v, shard_spec(k), axis) for k, v in tensors.items()}


def gather_params(tensors: Mapping[str, torch.Tensor], axis: Optional[ModelAxis]
                  ) -> Dict[str, torch.Tensor]:
    """This rank's tensors by name -> the full tensors, on every rank of
    the model axis: each split tensor's rank writes its slice into a
    zero-filled full buffer and one ``all_reduce`` over the model group
    (per dtype and device) sums them. ``shard_params`` then
    ``gather_params`` is the identity."""
    out = dict(tensors)
    if axis is None or axis.size == 1:
        return out
    split = [k for k, v in tensors.items() if shard_spec(k) is not None]
    buckets: Dict[tuple, List[str]] = {}
    for k in split:
        v = tensors[k]
        buckets.setdefault((v.dtype, v.device), []).append(k)
    for names in buckets.values():
        fulls = []
        for k in names:
            v, spec = tensors[k], shard_spec(k)
            shape = list(v.shape)
            shape[spec.dim] *= axis.size
            full = torch.zeros(shape, dtype=v.dtype, device=v.device)
            idx = shard_index(spec, shape[spec.dim], axis.size, axis.rank).to(v.device)
            fulls.append(full.index_copy_(spec.dim, idx, v.detach()))
        out.update(zip(names, all_reduce_sum(fulls, axis.group)))
    return out
