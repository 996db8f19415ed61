"""Megatron's two operators over a model axis, as autograd functions.

A column-parallel layer (qkv, fc1) takes a replicated input and gives each
model rank its own columns; the row-parallel layer after it (proj, fc2)
gives each rank a partial sum of the full output. Two operators make the
pair one layer (Shoeybi et al., Megatron-LM, 2019, section 3):

- ``copy_to_model``: the identity forward; its backward all-reduces the
  input gradient, whose ranks each hold the part their columns gave;
- ``reduce_from_model``: all-reduces the partial sums forward; its
  backward passes the (replicated) gradient to every rank as it is.

The JAX package gets the same two all-reduces from GSPMD under its
``_TP_RULES`` (``ssrl_vit_mae_jepa_tpu/parallel/mesh.py:57-65``). These
serve the plain route: the branches' plain versions on the CPU
(``ops/block_fused.py``) and the ``xla`` sub-layer route
(``models/vit.py``). The branch kernels' TP entries do the same
all-reduces inside their own autograd functions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ssrl_vit_mae_jepa_torch.parallel.mesh import ModelAxis


def _all_reduce(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _trivial(axis: Optional[ModelAxis]) -> bool:
    return axis is None or axis.size == 1


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """``x`` forward; the sum over the model group of its gradient backward
    (``x`` itself without a model axis)."""
    return x if _trivial(axis) else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The sum over the model group of ``x`` forward; the gradient as it is
    backward (``x`` itself without a model axis)."""
    return x if _trivial(axis) else _ReduceFromModel.apply(x, axis)
