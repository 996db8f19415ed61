"""Slot-packed attention's function on the natural layout, as a CUDA kernel.

Port of ``ssrl_vit_mae_jepa_tpu/ops/attention_pallas_packed.py::mha_packed``.
The TPU kernel spreads K and V block-diagonally so that one MXU product
serves every head; its function and rounding points are those of
``mha_stacked`` (pre-scaled q, ``ops/attention_core.py``), so on the card it
launches the same ``csrc/mha.cu`` entry, counted under its own name. Only
direct calls reach it, as in the JAX package.
"""

from __future__ import annotations

import torch

from ssrl_vit_mae_jepa_torch.ops.attention_core import Entry, attend, attend_plain

_PACKED = Entry("mha_packed", "natural", post=False)


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """Three (B, L, D) tensors → (B, L, D)."""
    return attend(_PACKED, (q, k, v), num_heads)


def mha_packed_ref(q, k, v, num_heads: int) -> torch.Tensor:
    return attend_plain(_PACKED, (q, k, v), num_heads)
