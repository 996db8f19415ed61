"""Masked Autoencoder (MAE) with a ViT backbone.

Port of ``ssrl_vit_mae_jepa_tpu/models/mae.py:40-243`` (lightly
``MaskedVisionTransformerTIMM`` + ``MAEDecoderTIMM`` contract): the encoder
runs on the kept tokens only; the decoder embeds them, fills a learned mask
token over the full sequence, scatters the encoded tokens back at
``idx_keep``, adds its position embedding, runs its blocks, gathers the
``idx_mask`` rows, norms them and predicts pixels. Targets are the patch
tokens at ``clamp(idx_mask - 1, 0)`` (the CLS offset; index 0 is never
masked, quirk Q7). ``forward_dense`` (the ``SSRL_MAE_DENSE_LOSS=1`` route)
predicts every token instead and leaves the masking to the loss's weights.

The module tree is lightly's, so ``state_dict()`` names match the
reference's ``vit-mae.pt``: ``encoder.vit.*``, the encoder's unused
``encoder.mask_token`` (a buffer here, so it never trains) and
``decoder.*``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ssrl_vit_mae_jepa_torch.models.vit import (
    LN_EPS,
    Block,
    VisionTransformer,
    dense,
    init_weights,
    norm,
    run_block_stack,
    trunc_normal_,
)
from ssrl_vit_mae_jepa_torch.ops.masking import get_at_index, repeat_token, set_at_index
from ssrl_vit_mae_jepa_torch.ops.patches import patchify


class MaskedVisionTransformer(nn.Module):
    """lightly's wrapper: the timm ViT under ``vit`` plus a mask token that
    the MAE forward never reads."""

    def __init__(self, vit: VisionTransformer):
        super().__init__()
        self.vit = vit
        self.register_buffer("mask_token", torch.zeros(1, 1, vit.embed_dim))


class MAEDecoder(nn.Module):
    """lightly ``MAEDecoderTIMM`` contract. ``with_pred=False`` leaves out the
    pixel head: the JEPA predictor reuses this class and never calls it, so
    its flax tree has no ``decoder_pred`` (flax makes a submodule's params
    only when it is called)."""

    def __init__(self, num_patches: int, patch_size: int, embed_dim: int,
                 decoder_embed_dim: int, decoder_depth: int, decoder_num_heads: int,
                 in_chans: int = 3, mlp_ratio: float = 4.0, dtype=torch.bfloat16,
                 attn_impl: str = "auto", with_pred: bool = True):
        super().__init__()
        dd = decoder_embed_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.decoder_embed = nn.Linear(embed_dim, dd)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd))
        self.decoder_pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, dd))
        self.decoder_blocks = nn.ModuleList(
            Block(dd, decoder_num_heads, mlp_ratio, dtype, attn_impl)
            for _ in range(decoder_depth)
        )
        self.decoder_norm = nn.LayerNorm(dd, eps=LN_EPS)
        if with_pred:
            self.decoder_pred = nn.Linear(dd, patch_size**2 * in_chans)

    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator)
        trunc_normal_(self.mask_token.data, 0.02, generator)
        trunc_normal_(self.decoder_pos_embed.data, 0.02, generator)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.decoder_embed, self.dtype)

    def decode_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Position embedding + decoder blocks, without the final norm
        (callers gather first and norm the gathered rows: LN is per token)."""
        x = x + self.decoder_pos_embed.to(self.dtype)
        return run_block_stack(x, self.decoder_blocks, self.attn_impl)

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return norm(x, self.decoder_norm, self.dtype)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.decoder_pred, self.dtype)


class MaskedAutoencoder(nn.Module):
    """MAE = masked ViT encoder + mask-token decoder → (pred, target)."""

    def __init__(self, image_size: int = 96, patch_size: int = 8, in_chans: int = 3,
                 embed_dim: int = 144, depth: int = 4, num_heads: int = 6,
                 decoder_embed_dim: int = 192, decoder_depth: int = 2,
                 decoder_num_heads: int = 6, dtype=torch.bfloat16,
                 attn_impl: str = "auto"):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.dtype = dtype
        vit = VisionTransformer(image_size, patch_size, in_chans, embed_dim, depth,
                                num_heads, dtype=dtype, attn_impl=attn_impl)
        self.num_patches = vit.num_patches
        self.sequence_length = vit.sequence_length
        self.encoder = MaskedVisionTransformer(vit)
        self.decoder = MAEDecoder(
            self.num_patches, patch_size, embed_dim, decoder_embed_dim,
            decoder_depth, decoder_num_heads, in_chans, dtype=dtype,
            attn_impl=attn_impl,
        )

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.vit.init_weights(generator)
        self.decoder.init_weights(generator)

    def forward_encoder(self, images, idx_keep=None) -> torch.Tensor:
        return self.encoder.vit(images, idx_keep)

    def decode(self, x_encoded, idx_keep) -> torch.Tensor:
        """The decoder's blocks over the mask-token sequence with the encoded
        tokens scattered in at ``idx_keep``: (B, L, Dd), before its norm."""
        dec = self.decoder
        x_decode = dec.embed(x_encoded)
        x_masked = repeat_token(
            dec.mask_token.to(self.dtype), (x_encoded.shape[0], self.sequence_length)
        )
        x_masked = set_at_index(x_masked, idx_keep, x_decode.to(x_masked.dtype))
        return dec.decode_tokens(x_masked)

    def forward_decoder(self, x_encoded, idx_keep, idx_mask) -> torch.Tensor:
        dec = self.decoder
        x_decoded = self.decode(x_encoded, idx_keep)
        # gather-then-norm: LN is per token, so norm only the masked rows
        x_pred = dec.norm(get_at_index(x_decoded, idx_mask))
        return dec.predict(x_pred)

    def forward_dense(self, images: torch.Tensor, idx_keep: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every token predicted, no masked-row gather: ``(pred, target)`` with
        pred (B, L, p·p·C), row 0 the CLS position, and target the (B, N,
        p·p·C) patches. The task weights the squared error by the masked
        tokens' occupancy, which gives the gathered loss and gradients
        (``models/mae.py:189-224`` of the JAX package); the decoder's norm
        and pixel head run over all L rows instead of the masked ones."""
        x_encoded = self.forward_encoder(images, idx_keep)
        dec = self.decoder
        x_pred = dec.predict(dec.norm(self.decode(x_encoded, idx_keep)))
        target = images if images.dim() == 3 else patchify(images, self.patch_size)
        return x_pred, target

    def forward(self, images: torch.Tensor, idx_keep: torch.Tensor,
                idx_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, C in [-1, 1]) or patch tokens (B, N, p·p·C),
        idx_keep (B, K), idx_mask (B, M) → (pred, target), both (B, M, p·p·C)."""
        x_encoded = self.forward_encoder(images, idx_keep)
        x_pred = self.forward_decoder(x_encoded, idx_keep, idx_mask)
        patches = images if images.dim() == 3 else patchify(images, self.patch_size)
        target = get_at_index(patches, (idx_mask - 1).clamp_min(0))
        return x_pred, target


def mae_from_config(model_cfg: dict, dtype=torch.bfloat16,
                    attn_impl: str = "auto") -> MaskedAutoencoder:
    """Build a MaskedAutoencoder from the reference YAML ``model`` section."""
    general = model_cfg.get("general", {})
    enc = model_cfg.get("encoder", {})
    dec = model_cfg.get("decoder", {})
    return MaskedAutoencoder(
        image_size=general.get("image_size", 96),
        patch_size=general.get("patch_size", 8),
        in_chans=general.get("in_chans", 3),
        embed_dim=enc.get("embed_dim", 144),
        depth=enc.get("depth", 4),
        num_heads=enc.get("num_heads", 6),
        decoder_embed_dim=dec.get("decoder_embed_dim", 192),
        decoder_depth=dec.get("decoder_depth", 2),
        decoder_num_heads=dec.get("decoder_num_heads", 6),
        dtype=dtype,
        attn_impl=attn_impl,
    )
