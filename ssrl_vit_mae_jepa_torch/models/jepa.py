"""JEPA: joint-embedding predictive architecture with ViT encoders.

Port of ``ssrl_vit_mae_jepa_tpu/models/jepa.py:34-179`` (I-JEPA adapted to
the STL-10 tiny-ViT geometry):

- the context encoder is the masked-encode ViT (CLS + context tokens);
- the target encoder has the same architecture; its weights are an EMA of
  the context encoder's, held by the task (``TrainState.extra``) and applied
  with ``torch.func.functional_call``, never parameters of this module;
- the predictor is ``MAEDecoder`` at its own width without the pixel head:
  it embeds the context tokens, fills every other position with the mask
  token, runs its blocks over the full sequence, gathers the target rows,
  norms them and projects them back to the encoder width
  (``predictor_proj``).

Parameter names: ``encoder.*`` (the ViT's timm names), ``predictor.*``
(lightly's decoder names minus ``decoder_pred``) and ``predictor_proj.*``.
Target indices repeat where blocks overlap; the gather's backward sums them.
``predict_dense`` and ``target_representations_dense`` (the
``SSRL_JEPA_DENSE_LOSS=1`` route) skip both gathers and return every token.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ssrl_vit_mae_jepa_torch.models.mae import MAEDecoder
from ssrl_vit_mae_jepa_torch.models.vit import VisionTransformer, dense, lecun_normal_
from ssrl_vit_mae_jepa_torch.ops.masking import get_at_index, repeat_token, set_at_index


class JEPA(nn.Module):
    def __init__(self, image_size: int = 96, patch_size: int = 8, in_chans: int = 3,
                 embed_dim: int = 144, depth: int = 4, num_heads: int = 6,
                 predictor_embed_dim: int = 96, predictor_depth: int = 2,
                 predictor_num_heads: int = 6, dtype=torch.bfloat16,
                 attn_impl: str = "auto"):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.dtype = dtype
        self.encoder = VisionTransformer(image_size, patch_size, in_chans, embed_dim, depth,
                                         num_heads, dtype=dtype, attn_impl=attn_impl)
        self.num_patches = self.encoder.num_patches
        self.sequence_length = self.encoder.sequence_length
        self.predictor = MAEDecoder(
            self.num_patches, patch_size, embed_dim, predictor_embed_dim, predictor_depth,
            predictor_num_heads, in_chans, dtype=dtype, attn_impl=attn_impl, with_pred=False,
        )
        self.predictor_proj = nn.Linear(predictor_embed_dim, embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        self.predictor.init_weights(generator)
        # nn.Dense with flax's default kernel init (models/jepa.py:81-83 of
        # the JAX package)
        lecun_normal_(self.predictor_proj.weight, self.predictor_proj.in_features, generator)
        nn.init.zeros_(self.predictor_proj.bias)

    def encode_context(self, images, idx_ctx_tokens) -> torch.Tensor:
        """Context encoder over CLS + context tokens."""
        return self.encoder(images, idx_ctx_tokens)

    def _decode(self, x_ctx, idx_ctx_tokens) -> torch.Tensor:
        """The predictor's blocks over the mask-token sequence with the
        context scattered in: (B, L, Dp), before its norm."""
        p = self.predictor
        x = p.embed(x_ctx)
        seq = repeat_token(p.mask_token.to(self.dtype), (x_ctx.shape[0], self.sequence_length))
        seq = set_at_index(seq, idx_ctx_tokens, x.to(seq.dtype))
        return p.decode_tokens(seq)

    def predict_targets(self, x_ctx, idx_ctx_tokens, idx_target_tokens) -> torch.Tensor:
        """Predicted target latents (B, T, D) from the encoded context."""
        decoded = self._decode(x_ctx, idx_ctx_tokens)
        # gather-then-norm: LN is per token, so norm only the target rows
        pred = self.predictor.norm(get_at_index(decoded, idx_target_tokens))
        return dense(pred, self.predictor_proj, self.dtype)

    def predict_dense(self, images, idx_ctx_tokens) -> torch.Tensor:
        """Predicted latents of every token (B, L, D), no target gather
        (``models/jepa.py:110-136`` of the JAX package): the task weights
        the latent error by the targets' occupancy, so the non-target rows
        get no gradient; the predictor's norm and projection run over all
        L rows."""
        decoded = self._decode(self.encode_context(images, idx_ctx_tokens), idx_ctx_tokens)
        return dense(self.predictor.norm(decoded), self.predictor_proj, self.dtype)

    def target_representations_dense(self, encoder_params: Dict[str, torch.Tensor],
                                      images) -> torch.Tensor:
        """Full-sequence representations (B, L, D) under ``encoder_params``,
        ungathered."""
        return torch.func.functional_call(self.encoder, encoder_params, (images,))

    def forward(self, images, idx_ctx_tokens, idx_target_tokens) -> torch.Tensor:
        """Context side: images (B, H, W, C) or patch tokens (B, N, p·p·C)
        → predicted latents (B, T, D)."""
        x_ctx = self.encode_context(images, idx_ctx_tokens)
        return self.predict_targets(x_ctx, idx_ctx_tokens, idx_target_tokens)

    def target_representations(self, encoder_params: Dict[str, torch.Tensor], images,
                               idx_target_tokens) -> torch.Tensor:
        """Full-sequence encode with ``encoder_params`` (the EMA weights, by
        the encoder's own names), then gather the target tokens."""
        tokens = self.target_representations_dense(encoder_params, images)
        return get_at_index(tokens, idx_target_tokens)


def jepa_from_config(model_cfg: dict, jepa_cfg: dict, dtype=torch.bfloat16,
                     attn_impl: str = "auto") -> JEPA:
    """Build a JEPA from the reference YAML ``model`` and ``jepa`` sections."""
    general = model_cfg.get("general", {})
    enc = model_cfg.get("encoder", {})
    return JEPA(
        image_size=general.get("image_size", 96),
        patch_size=general.get("patch_size", 8),
        in_chans=general.get("in_chans", 3),
        embed_dim=enc.get("embed_dim", 144),
        depth=enc.get("depth", 4),
        num_heads=enc.get("num_heads", 6),
        predictor_embed_dim=jepa_cfg.get("predictor_embed_dim", 96),
        predictor_depth=jepa_cfg.get("predictor_depth", 2),
        predictor_num_heads=jepa_cfg.get("predictor_num_heads", 6),
        dtype=dtype,
        attn_impl=attn_impl,
    )
