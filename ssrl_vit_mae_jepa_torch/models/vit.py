"""Vision Transformer with the masked-encode path.

Port of ``ssrl_vit_mae_jepa_tpu/models/vit.py`` (timm 1.0.21
``VisionTransformer`` contract with ``num_classes=0``): patch embedding as a
matmul over CHW-within-patch tokens, CLS + learned position embedding,
optional ``idx_keep`` gather after the position embedding (lightly
``MaskedVisionTransformerTIMM.encode``), pre-LN blocks and the final LN.

Parameters keep timm's names and layouts (``patch_embed.proj.weight`` is
(D, C, p, p) and is viewed as (D, C·p·p) in the forward), so the state dicts
of ``utils/torch_interop.py`` and the reference's ``.pt`` files load with
``strict=True``. Parameters are f32; the forward computes in ``dtype``
(bf16 by default) with LayerNorm statistics in f32.

A ``Block`` runs its two residual branches through
``ops/block_fused.py``: the CUDA kernels for a CUDA tensor, the plain
versions for a CPU tensor. There is no other route.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ssrl_vit_mae_jepa_torch.ops.block_fused import (
    LN_EPS,
    fused_attn_branch,
    fused_mlp_branch,
    layer_norm,
)
from ssrl_vit_mae_jepa_torch.ops.masking import get_at_index
from ssrl_vit_mae_jepa_torch.ops.patches import patchify


def dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """``nn.Dense(dtype)``'s promote-then-matmul: cast, matmul, add bias."""
    return x.to(dtype) @ lin.weight.to(dtype).t() + lin.bias.to(dtype)


def norm(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    return layer_norm(x, ln.weight, ln.bias).to(dtype)


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class Mlp(nn.Module):
    """fc1/fc2 parameters of the MLP branch (timm names)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    """qkv/proj parameters of the attention branch (timm names)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, m = self.attn, self.mlp
        x = fused_attn_branch(
            x.to(self.dtype), self.norm1.weight, self.norm1.bias,
            a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, a.num_heads,
        )
        return fused_mlp_branch(
            x, self.norm2.weight, self.norm2.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
        )


def run_block_stack(x: torch.Tensor, blocks) -> torch.Tensor:
    for blk in blocks:
        x = blk(x)
    return x


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers: trunc-normal(0.02) Linear weights,
    zero biases, unit LayerNorm scales, lecun-normal patch embedding."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            trunc_normal_(m.weight, fan_in**-0.5, generator)
            nn.init.zeros_(m.bias)


class PatchEmbed(nn.Module):
    """Holds timm's conv weight (D, C, p, p); applied as a matmul."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)


class VisionTransformer(nn.Module):
    """Tokens-out ViT (timm ``num_classes=0`` contract)."""

    def __init__(self, img_size: int = 96, patch_size: int = 8, in_chans: int = 3,
                 embed_dim: int = 144, depth: int = 4, num_heads: int = 6,
                 mlp_ratio: float = 4.0, dtype=torch.bfloat16):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.num_patches = (img_size // patch_size) ** 2
        self.sequence_length = self.num_patches + 1
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.sequence_length, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator)
        trunc_normal_(self.cls_token.data, 0.02, generator)
        trunc_normal_(self.pos_embed.data, 0.02, generator)

    def forward(self, images: torch.Tensor,
                idx_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, C) images or (B, N, p·p·C) tokens → (B, L', D) normed
        tokens; with ``idx_keep`` (B, K) only the kept tokens (gathered after
        the position embedding) run through the blocks."""
        dt = self.dtype
        B, D = images.shape[0], self.embed_dim
        patches = (images.to(dt) if images.dim() == 3
                   else patchify(images.to(dt), self.patch_size))
        proj = self.patch_embed.proj
        x = patches @ proj.weight.reshape(D, -1).to(dt).t() + proj.bias.to(dt)
        cls = self.cls_token.to(dt).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        if idx_keep is not None:
            x = get_at_index(x, idx_keep)
        x = run_block_stack(x, self.blocks)
        return norm(x, self.norm, dt)
