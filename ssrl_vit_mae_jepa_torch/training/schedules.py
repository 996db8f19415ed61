"""LR schedule, mask-ratio ramp and JEPA EMA momentum (port of
``ssrl_vit_mae_jepa_tpu/training/schedules.py:17-47``).

- factor(epoch) = min((epoch+1)/warmup, 1) * 0.5*(1 + cos(pi*epoch/total)):
  the cosine applies during warmup too (quirk Q2), stepped per epoch;
- pretraining scales the LR by batch/256 (quirk Q3).
"""

from __future__ import annotations

import math

import torch


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


def ema_momentum_at_step(step, total_steps: int, start: float, end: float) -> torch.Tensor:
    """JEPA EMA momentum, linear from start to end over all training steps
    (I-JEPA anneals per step), in f32 as the JAX package computes it:
    ``f32(start) + min(f32(step) / f32(total), 1) * f32(end - start)``.
    ``step`` is an int or a 0-d tensor; the result is a 0-d f32 tensor on
    its device, so the train step computes it from the optimizer's count
    without a host number (``float()`` it on the host)."""
    step = torch.as_tensor(step).float()
    # a tensor denominator: a host scalar would divide by its reciprocal on CUDA
    total = torch.full((), float(max(1, total_steps)), dtype=torch.float32, device=step.device)
    frac = torch.clamp_max(step / total, 1.0)
    return start + frac * (end - start)
