"""Patchify / unpatchify between images and flattened patch tokens.

Port of ``ssrl_vit_mae_jepa_tpu/ops/patches.py``: images are NHWC, the patch
grid is row-major and each flattened patch is CHW (channel first) — the
layout timm's conv patch-embed weight flattens to.
"""

from __future__ import annotations

import torch


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) images → (B, N, p*p*C) tokens, N = (H/p)*(W/p)."""
    B, H, W, C = images.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = images.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gw, p * p * C)


def patchify_hcw(x_hcw: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, C, W) images → (B, N, p*p*C) tokens (same contract as
    :func:`patchify`), from the layout the augmentation's column resample
    produces."""
    B, H, C, W = x_hcw.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = x_hcw.reshape(B, gh, p, C, gw, p).permute(0, 1, 4, 3, 2, 5)
    return x.reshape(B, gh * gw, p * p * C)


def unpatchify(patches: torch.Tensor, patch_size: int, channels: int = 3) -> torch.Tensor:
    """(B, N, p*p*C) tokens → (B, H, W, C) images (inverse of patchify)."""
    B, N, _ = patches.shape
    p = patch_size
    gh = gw = int(round(N**0.5))
    x = patches.reshape(B, gh, gw, channels, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, gh * p, gw * p, channels)
