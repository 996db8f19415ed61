"""On-device image augmentation: random-resized-crop, flip and normalize,
as images or fused with patchify; and the eval transform.

Port of ``ssrl_vit_mae_jepa_tpu/ops/augment.py`` (all of it). The bilinear crop
resample is two batched contractions against per-image weight matrices
(each row has at most two nonzeros), with the horizontal flip folded into
the source coordinates. Crop semantics follow torchvision's
RandomResizedCrop with the box clamped to the image instead of its
rejection loop, as in the JAX package. The randomness comes from
:func:`draw_augment_params`; every function that applies it takes the
pre-drawn ``(u, flip)``, so tests can feed JAX's draws.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ssrl_vit_mae_jepa_torch.ops.patches import patchify_hcw

DEFAULT_RATIO = (3.0 / 4.0, 4.0 / 3.0)


def normalize(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] → dtype in [-1, 1] (Normalize(mean=.5, std=.5))."""
    return images_u8.to(dtype) * (2.0 / 255.0) - 1.0


def draw_augment_params(generator: torch.Generator, batch: int):
    """``(u, flip)``: (B, 4) crop uniforms and (B,) bools, on the
    generator's device."""
    u = torch.rand((batch, 4), generator=generator, device=generator.device)
    flip = torch.rand((batch,), generator=generator, device=generator.device) < 0.5
    return u, flip


def _crop_box_from_u(u, height: int, width: int, scale, ratio):
    """(B, 4) uniforms → (top, left, crop_h, crop_w)."""
    area = height * width
    target_area = area * (scale[0] + u[:, 0] * (scale[1] - scale[0]))
    log_lo, log_hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(log_lo + u[:, 1] * (log_hi - log_lo))
    w = torch.sqrt(target_area * aspect).clamp(1.0, float(width))
    h = torch.sqrt(target_area / aspect).clamp(1.0, float(height))
    top = u[:, 2] * (height - h)
    left = u[:, 3] * (width - w)
    return top, left, h, w


def _axis_weights(start, size, out_n: int, limit: int, flip=None) -> torch.Tensor:
    """(B, out_n, limit) bilinear weights for one axis; ``flip`` (B,) bool
    reverses the output rows by reversing the source coordinates."""
    o = torch.arange(out_n, device=start.device, dtype=torch.float32)
    src = start[:, None] + (o[None, :] + 0.5) * (size[:, None] / out_n) - 0.5
    src = src.clamp(0.0, float(limit - 1))
    if flip is not None:
        src = torch.where(flip[:, None], src.flip(-1), src)
    s = torch.arange(limit, device=start.device, dtype=torch.float32)
    return (1.0 - (src[:, :, None] - s[None, None, :]).abs()).clamp_min(0.0)


def _crop_resize_cols(images, tops, lefts, hs, ws, out_hw: Tuple[int, int],
                      flip_x=None) -> torch.Tensor:
    """(B, H, W, C) f32 → (B, out_h, C, out_w) bilinear crop resample."""
    B, H, W, C = images.shape
    out_h, out_w = out_hw
    wy = _axis_weights(tops, hs, out_h, H)                # (B, out_h, H)
    wx = _axis_weights(lefts, ws, out_w, W, flip=flip_x)  # (B, out_w, W)
    rows = torch.bmm(wy, images.reshape(B, H, W * C)).reshape(B, out_h, W, C)
    # contract W as one batched product: (B, out_h·C, W) @ (B, W, out_w)
    rows = rows.transpose(2, 3).reshape(B, out_h * C, W)
    return torch.bmm(rows, wx.transpose(1, 2)).reshape(B, out_h, C, out_w)


def _crop_resize_batch(images, tops, lefts, hs, ws, out_hw: Tuple[int, int],
                       flip_x=None) -> torch.Tensor:
    """(B, H, W, C) f32 → (B, out_h, out_w, C) bilinear crop resample."""
    cols = _crop_resize_cols(images, tops, lefts, hs, ws, out_hw, flip_x)
    return cols.permute(0, 1, 3, 2)


def apply_augment(
    u: torch.Tensor,
    flip: torch.Tensor,
    images_u8: torch.Tensor,
    out_size: int = 96,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = DEFAULT_RATIO,
    dtype=torch.float32,
) -> torch.Tensor:
    """uint8 (B, H, W, C) → augmented (B, out, out, C) images in [-1, 1]
    (the image-space train transform, ``SSRL_AUG_PATCHES=0``)."""
    _, H, W, _ = images_u8.shape
    images = normalize(images_u8, dtype=torch.float32)
    tops, lefts, hs, ws = _crop_box_from_u(u, H, W, scale, ratio)
    out = _crop_resize_batch(images, tops, lefts, hs, ws, (out_size, out_size), flip_x=flip)
    return out.to(dtype).contiguous()


def random_resized_crop_flip_normalize(
    generator: torch.Generator,
    images_u8: torch.Tensor,
    out_size: int = 96,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = DEFAULT_RATIO,
    dtype=torch.float32,
) -> torch.Tensor:
    """Draw ``(u, flip)`` from ``generator``, then :func:`apply_augment`."""
    u, flip = draw_augment_params(generator, images_u8.shape[0])
    return apply_augment(u, flip, images_u8, out_size=out_size, scale=scale, ratio=ratio,
                         dtype=dtype)


def apply_augment_patches(
    u: torch.Tensor,
    flip: torch.Tensor,
    images_u8: torch.Tensor,
    patch_size: int = 8,
    out_size: int = 96,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = DEFAULT_RATIO,
    dtype=torch.float32,
) -> torch.Tensor:
    """uint8 (B, H, W, C) → augmented (B, N, p*p*C) patch tokens."""
    _, H, W, _ = images_u8.shape
    images = normalize(images_u8, dtype=torch.float32)
    tops, lefts, hs, ws = _crop_box_from_u(u, H, W, scale, ratio)
    cols = _crop_resize_cols(
        images, tops, lefts, hs, ws, (out_size, out_size), flip_x=flip
    )
    return patchify_hcw(cols, patch_size).to(dtype)


def _resize_weights(in_n: int, out_n: int, device) -> torch.Tensor:
    """(in_n, out_n) weights of ``jax.image.resize(..., "linear")`` along one
    axis (``compute_weight_mat`` of ``jax._src.image.scale``): the triangle
    kernel at half-pixel centres, widened by in/out when shrinking (the
    antialias), each column normalised to sum 1, in f32."""
    inv_scale = 1.0 / (out_n / in_n)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_n, dtype=torch.float32, device=device)
    w = (1.0 - (sample[None, :] - src[:, None]).abs() / kernel_scale).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_n - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(B, H, W, C) f32 → (B, new_h, new_w, C), as ``jax.image.resize`` with
    ``method="linear"`` (antialiased when it shrinks); an axis whose size
    does not change is left as it is."""
    _, H, W, _ = x.shape
    if H != new_h:
        x = torch.einsum("bhwc,hy->bywc", x, _resize_weights(H, new_h, x.device))
    if W != new_w:
        x = torch.einsum("bhwc,wx->bhxc", x, _resize_weights(W, new_w, x.device))
    return x


def eval_transform(images_u8: torch.Tensor, out_size: int = 96,
                   dtype=torch.float32) -> torch.Tensor:
    """Resize(out_size) of the short side + CenterCrop(out_size) + normalize:
    uint8 (B, H, W, C) → (B, out, out, C) in [-1, 1]. For STL-10's 96×96
    inputs at out_size 96 the geometric part is the identity."""
    B, H, W, C = images_u8.shape
    x = normalize(images_u8, dtype=torch.float32)
    if (H, W) != (out_size, out_size):
        short = min(H, W)
        new_h, new_w = ((out_size, int(round(out_size * W / short))) if H <= W
                        else (int(round(out_size * H / short)), out_size))
        x = resize_linear(x, new_h, new_w)
        top, left = (new_h - out_size) // 2, (new_w - out_size) // 2
        x = x[:, top:top + out_size, left:left + out_size]
    return x.to(dtype).contiguous()
