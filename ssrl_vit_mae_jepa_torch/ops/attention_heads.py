"""Per-head attention on (B, H, L, d), as a CUDA kernel.

Port of ``ssrl_vit_mae_jepa_tpu/ops/attention_pallas.py::mha_pallas``, with
its post-scaled contract (``ops/attention_core.py``): the f32 scores are
scaled after QKᵀ, and dq and dk are scaled after their products. At the
model's head dims (24, 32) 1/√d is not a power of two, so this rounds
differently in bf16 from the pre-scaled entries. ``csrc/mha.cu`` runs it
with one block per (image, head).

:func:`mha_pallas` launches the kernel for a CUDA tensor and runs
:func:`mha_pallas_ref` (plain, explicit backward) for a CPU tensor.
"""

from __future__ import annotations

import torch

from ssrl_vit_mae_jepa_torch.ops.attention_core import Entry, attend, attend_plain

_HEADS = Entry("mha_pallas", "heads", post=True)


def mha_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) → (B, H, L, d)."""
    return attend(_HEADS, (q, k, v))


def mha_pallas_ref(q, k, v) -> torch.Tensor:
    return attend_plain(_HEADS, (q, k, v))
