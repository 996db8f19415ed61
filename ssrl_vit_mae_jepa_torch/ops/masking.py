"""Per-sample random token masking and batched token gather/scatter.

Port of ``ssrl_vit_mae_jepa_tpu/ops/masking.py`` (lightly 1.5.22 contract):
indices are token-space with CLS at 0, CLS is never masked and always kept,
``num_masked = int(mask_ratio * (L - 1))``, and the kept patch indices are
sorted. Gathers and scatters are ``torch.gather``/``torch.scatter``; the
JAX package's one-hot-matmul forms exist for the TPU's layout and are exact
for unique indices, so the values agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch


def num_masked_tokens(sequence_length: int, mask_ratio: float) -> int:
    """Static count of masked tokens (CLS excluded from the pool)."""
    return int(mask_ratio * (sequence_length - 1))


def random_token_mask(
    generator: torch.Generator,
    batch_size: int,
    sequence_length: int,
    num_masked: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform per-sample masking with CLS kept: ``(idx_keep, idx_mask)`` of
    shapes (B, L - num_masked) and (B, num_masked), int64, on the
    generator's device; ``idx_keep[:, 0] == 0`` and the rest ascend."""
    noise = torch.rand(
        (batch_size, sequence_length - 1), generator=generator,
        device=generator.device,
    )
    perm = torch.argsort(noise, dim=-1) + 1  # random permutation of 1..L-1
    idx_mask = perm[:, :num_masked]
    idx_keep = torch.sort(perm[:, num_masked:], dim=-1).values
    cls = torch.zeros((batch_size, 1), dtype=perm.dtype, device=perm.device)
    return torch.cat([cls, idx_keep], dim=-1), idx_mask


def _expand(index: torch.Tensor, D: int) -> torch.Tensor:
    return index.unsqueeze(-1).expand(-1, -1, D)


def get_at_index(tokens: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(B, L, D)[(B, K)] → (B, K, D)."""
    return torch.gather(tokens, 1, _expand(index, tokens.shape[-1]))


def set_at_index(
    tokens: torch.Tensor, index: torch.Tensor, value: torch.Tensor
) -> torch.Tensor:
    """Out-of-place write of (B, K, D) ``value`` rows at (B, K) ``index``."""
    return torch.scatter(tokens, 1, _expand(index, tokens.shape[-1]), value)


def token_occupancy(index: torch.Tensor, length: int) -> torch.Tensor:
    """(B, K) token indices → (B, length) f32 counts: how often each token
    is indexed (the JAX one-hot sum, ``one_hot(index, length).sum(1)``)."""
    occ = torch.zeros(index.shape[0], length, dtype=torch.float32, device=index.device)
    return occ.scatter_add_(1, index, torch.ones(index.shape, dtype=torch.float32,
                                                 device=index.device))


def repeat_token(token: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Broadcast a (1, 1, D) token to (B, L, D)."""
    B, L = size
    return token.expand(B, L, token.shape[-1])
