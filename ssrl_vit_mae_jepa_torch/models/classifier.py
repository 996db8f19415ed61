"""ViT classifier: encoder tokens → pool → linear head.

Port of ``ssrl_vit_mae_jepa_tpu/models/classifier.py`` (reference
``src/models/classifier.py:10-57``): the timm ViT under ``encoder``, one
Linear named ``head.classification`` (trunc-normal(0.02) weight, zero
bias), and pooling over the CLS token (``pool="cls"``) or the mean over
**all** tokens including CLS (``pool="mean"``, quirk Q6). The logits are
f32. Parameter names are the reference's (``encoder.*`` timm keys and
``head.classification.{weight,bias}``), so its state dicts load with
``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from ssrl_vit_mae_jepa_torch.models.vit import VisionTransformer, dense, trunc_normal_


class ClassificationHead(nn.Module):
    def __init__(self, embed_dim: int, num_classes: int = 10, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.classification = nn.Linear(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.classification, self.dtype)


class ViTClassifier(nn.Module):
    """Classifier on top of a (pretrained) ViT encoder."""

    def __init__(self, img_size: int = 96, patch_size: int = 8, in_chans: int = 3,
                 embed_dim: int = 144, depth: int = 4, num_heads: int = 6,
                 num_classes: int = 10, pool: str = "cls", dtype=torch.bfloat16,
                 attn_impl: str = "auto"):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"unknown pool {pool!r} (expected cls|mean)")
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.depth = depth
        self.pool = pool
        self.dtype = dtype
        self.encoder = VisionTransformer(img_size, patch_size, in_chans, embed_dim, depth,
                                         num_heads, dtype=dtype, attn_impl=attn_impl)
        self.head = ClassificationHead(embed_dim, num_classes, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        trunc_normal_(self.head.classification.weight, 0.02, generator)
        nn.init.zeros_(self.head.classification.bias)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images or (B, N, p·p·C) tokens → pooled (B, D)."""
        feats = self.encoder(images)
        if self.pool == "cls":
            return feats[:, 0]
        # jnp.mean sums a bf16 input in f32 and rounds the mean once
        return feats.float().mean(dim=1).to(feats.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """→ (B, num_classes) f32 logits."""
        return self.head(self.features(images)).float()


def classifier_from_config(model_cfg: dict, num_classes: int = 10, dtype=torch.bfloat16,
                           attn_impl: str = "auto") -> ViTClassifier:
    """Build a ViTClassifier from the reference YAML ``model`` section."""
    general = model_cfg.get("general", {})
    enc = model_cfg.get("encoder", {})
    head = model_cfg.get("head", {}) or {}
    return ViTClassifier(
        img_size=general.get("image_size", 96),
        patch_size=general.get("patch_size", 8),
        in_chans=general.get("in_chans", 3),
        embed_dim=enc.get("embed_dim", 144),
        depth=enc.get("depth", 4),
        num_heads=enc.get("num_heads", 6),
        num_classes=num_classes,
        pool=head.get("pool", "cls"),
        dtype=dtype,
        attn_impl=attn_impl,
    )
