"""I-JEPA multi-block masking with static counts.

Port of ``ssrl_vit_mae_jepa_tpu/ops/jepa_masking.py``. Each image gets
``num_blocks`` rectangular target blocks whose shape is drawn from the
static (h, w) factorizations of ``block_area`` within the aspect range and
whose top-left corner is uniform, so:

- every target block covers exactly ``block_area`` patches;
- blocks may overlap (as in I-JEPA), so target indices may repeat;
- the context is a fixed count of ``context_size`` non-target patches, by
  one of two samplers: ``complement`` (uniform over the non-targets) or
  ``block`` (a square block of scale ``context_scale`` minus the targets,
  topped up from outside the block only when it holds too few).

Indices are patch-space [0, N), int64, on the generator's device; callers
add the CLS offset. The context indices come out in priority order
(``argsort``), not sorted. The draws are ``torch.rand``/``torch.randint``
from the given generator, so they differ from ``jax.random``'s.
"""

from __future__ import annotations

import functools

from typing import List, Tuple

import torch


def block_shapes_for(
    area: int, aspect_range: Tuple[float, float] = (0.75, 1.5)
) -> List[Tuple[int, int]]:
    """Static (h, w) factorizations of ~area with aspect h/w in range."""
    shapes = []
    for h in range(1, area + 1):
        w = max(1, round(area / h))
        if h * w != area:
            continue
        aspect = h / w
        if aspect_range[0] <= aspect <= aspect_range[1]:
            shapes.append((h, w))
    if not shapes:  # fall back to the squarest factor pair
        best = min(
            (
                (abs(h - area // h), (h, area // h))
                for h in range(1, area + 1)
                if area % h == 0
            ),
        )[1]
        shapes = [best]
    return shapes


@functools.lru_cache(maxsize=None)
def _block_tables(grid_size: int, block_area: int, aspect_range: Tuple[float, float],
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The static per-shape offset tables (S, area, 2) and corner limits
    (S, 2) on ``device``, made once: a copy to the card in every step would
    also be a host sync, which a CUDA graph's capture refuses."""
    shapes = block_shapes_for(block_area, aspect_range)
    offs = torch.zeros((len(shapes), block_area, 2), dtype=torch.long)
    max_top = torch.zeros((len(shapes), 2), dtype=torch.long)
    for s, (h, w) in enumerate(shapes):
        dy, dx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        offs[s, :, 0] = dy.reshape(-1)
        offs[s, :, 1] = dx.reshape(-1)
        max_top[s] = torch.tensor([grid_size - h, grid_size - w])
    return offs.to(device), max_top.to(device)


def sample_jepa_masks(
    generator: torch.Generator,
    batch_size: int,
    grid_size: int,
    num_blocks: int,
    block_area: int,
    context_size: int,
    aspect_range: Tuple[float, float] = (0.75, 1.5),
    context_sampling: str = "complement",
    context_scale: Tuple[float, float] = (0.85, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (target_idx (B, num_blocks·block_area), ctx_idx (B, context_size)),
    patch-space indices."""
    if context_sampling not in ("complement", "block"):
        raise ValueError(f"unknown context_sampling: {context_sampling}")
    dev = generator.device
    B, N = batch_size, grid_size * grid_size
    offs, max_top = _block_tables(grid_size, block_area, tuple(aspect_range), dev)

    shape_id = torch.randint(len(offs), (B, num_blocks), generator=generator, device=dev)
    u = torch.rand((B, num_blocks, 2), generator=generator, device=dev)
    top_left = torch.floor(u * (max_top[shape_id] + 1)).long()  # (B, M, 2)
    yx = top_left[:, :, None, :] + offs[shape_id]  # (B, M, area, 2)
    target_idx = (yx[..., 0] * grid_size + yx[..., 1]).reshape(B, -1)

    # context: fixed-count priority sample; the lowest priority wins a slot
    # and targets carry a penalty that no non-target reaches
    is_target = torch.zeros((B, N), device=dev).scatter_(1, target_idx, 1.0)
    priority = torch.rand((B, N), generator=generator, device=dev) + is_target * 20.0
    if context_sampling == "block":
        lo, hi = context_scale
        s = lo + torch.rand((B, 1), generator=generator, device=dev) * (hi - lo)
        side = torch.floor(grid_size * torch.sqrt(s)).long().clamp(1, grid_size)
        u2 = torch.rand((B, 2), generator=generator, device=dev)
        corner = torch.floor(u2 * (grid_size - side + 1)).long()  # (B, 2)
        pos = torch.arange(N, device=dev)
        rows, cols = pos // grid_size, pos % grid_size
        in_block = ((rows >= corner[:, :1]) & (rows < corner[:, :1] + side)
                    & (cols >= corner[:, 1:]) & (cols < corner[:, 1:] + side))
        priority = priority + torch.where(in_block, 0.0, 5.0)
    ctx_idx = torch.argsort(priority, dim=-1)[:, :context_size]
    return target_idx, ctx_idx
