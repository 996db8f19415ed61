"""Plain multi-head attention.

Port of ``ssrl_vit_mae_jepa_tpu/ops/attention.py::mha_xla``: f32 scores and
softmax, probabilities rounded to the input dtype before PV, the PV product
accumulated in f32 and rounded once.
"""

from __future__ import annotations

from typing import Optional

import torch


def mha_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, L, d) tensors → (B, H, L, d); ``scale``
    defaults to d^-½ (pass 1.0 for queries that are already scaled)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)
