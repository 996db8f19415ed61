"""LR schedule and mask-ratio ramp (port of
``ssrl_vit_mae_jepa_tpu/training/schedules.py:17-40``).

- factor(epoch) = min((epoch+1)/warmup, 1) * 0.5*(1 + cos(pi*epoch/total)):
  the cosine applies during warmup too (quirk Q2), stepped per epoch;
- pretraining scales the LR by batch/256 (quirk Q3).
"""

from __future__ import annotations

import math


def warmup_cosine_factor(epoch: float, warmup_epochs: int, total_epochs: int) -> float:
    warmup = (epoch + 1.0) / max(1, warmup_epochs)
    cosine = 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))
    return min(warmup, 1.0) * cosine


def effective_pretrain_lr(base_lr: float, batch_size: int) -> float:
    return base_lr * batch_size / 256.0


def mask_ratio_at_epoch(epoch: int, start: float, end: float, ramp_epochs: int) -> float:
    """Linear per-epoch mask-ratio ramp with denominator ramp_epochs - 1."""
    progress = min(epoch / max(1, ramp_epochs - 1), 1.0)
    return start + progress * (end - start)
