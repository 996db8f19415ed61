"""Head-stacked attention on the natural layout, as a CUDA kernel.

Port of ``ssrl_vit_mae_jepa_tpu/ops/attention_pallas_stacked.py``: the same
function and rounding points (pre-scaled q; ``ops/attention_core.py``), not
the TPU layout: the head-stacked queries, slot masks and head groups there
exist for the MXU's 128-lane tiles. Here one block per (image, head) of
``csrc/mha.cu`` reads its head's columns in place.

- :func:`mha_stacked_qkv` takes the fused (B, L, 3D) qkv tensor straight
  from the qkv projection and returns (B, L, D); its gradient is one
  (B, L, 3D) dqkv.
- :func:`mha_stacked` takes three (B, L, D) tensors.

Each launches the kernel for a CUDA tensor and runs its plain version
(``*_ref``, with an explicit backward) for a CPU tensor.
"""

from __future__ import annotations

import torch

from ssrl_vit_mae_jepa_torch.ops.attention_core import Entry, attend, attend_plain

_QKV = Entry("mha_stacked_qkv", "qkv", post=False)
_SPLIT = Entry("mha_stacked", "natural", post=False)


def mha_stacked_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, 3D) fused [q | k | v] → (B, L, D)."""
    return attend(_QKV, (qkv,), num_heads)


def mha_stacked_qkv_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    return attend_plain(_QKV, (qkv,), num_heads)


def mha_stacked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_heads: int) -> torch.Tensor:
    """Three (B, L, D) tensors → (B, L, D)."""
    return attend(_SPLIT, (q, k, v), num_heads)


def mha_stacked_ref(q, k, v, num_heads: int) -> torch.Tensor:
    return attend_plain(_SPLIT, (q, k, v), num_heads)
