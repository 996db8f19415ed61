"""Vision Transformer with the masked-encode path.

Port of ``ssrl_vit_mae_jepa_tpu/models/vit.py`` (timm 1.0.21
``VisionTransformer`` contract with ``num_classes=0``): patch embedding as a
matmul over CHW-within-patch tokens, CLS + learned position embedding,
optional ``idx_keep`` gather after the position embedding (lightly
``MaskedVisionTransformerTIMM.encode``), pre-LN blocks and the final LN.
With ``SSRL_FUSED_EMBED=1`` (or ``force``) that prologue is one call of
``ops/embed_fused.py::fused_patch_embed``, as the JAX package dispatches it
(``models/vit.py:428-452``).

Parameters keep timm's names and layouts (``patch_embed.proj.weight`` is
(D, C, p, p) and is viewed as (D, C·p·p) in the forward), so the state dicts
of ``utils/torch_interop.py`` and the reference's ``.pt`` files load with
``strict=True``. Parameters are f32; the forward computes in ``dtype``
(bf16 by default) with LayerNorm statistics in f32.

A ``Block`` takes one of three routes, chosen by ``attn_impl`` as the JAX
package's ``block_impl`` chooses (``block_impl`` below):

- the branch route (auto, split, split_pad): the two residual branches
  through ``ops/block_fused.py``;
- the whole-block route (block): ``ops/block_fused.py::fused_block``;
- the sub-layer route (xla, pallas, packed, stacked, chain): LN,
  ``Attention``, LN, ``Mlp`` as separate modules, with attention dispatched
  by ``ops/attention.py`` to ``mha_xla`` or to an attention kernel.

Under ``attn_impl="chain"`` a stack of blocks (``run_block_stack``) runs as
one chain, ``ops/block_chain.py``, reading each block's 12 tensors from its
modules (so ``torch.func.functional_call`` still substitutes them). Each
kernel runs on a CUDA tensor and its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ssrl_vit_mae_jepa_torch.ops.attention import (
    mha_natural,
    mha_natural_qkv,
    multi_head_attention,
    use_packed,
    use_stacked_split,
    validate_impl,
)
from ssrl_vit_mae_jepa_torch.ops.block_chain import chain_impl, fused_block_chain
from ssrl_vit_mae_jepa_torch.ops.block_fused import (
    LN_EPS,
    fused_attn_branch,
    fused_block,
    fused_mlp_branch,
    layer_norm,
)
from ssrl_vit_mae_jepa_torch.ops.embed_fused import fused_patch_embed, use_fused_embed
from ssrl_vit_mae_jepa_torch.ops.masking import get_at_index
from ssrl_vit_mae_jepa_torch.ops.patches import patchify


def dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """``nn.Dense(dtype)``'s promote-then-matmul: cast, matmul, add bias."""
    return x.to(dtype) @ lin.weight.to(dtype).t() + lin.bias.to(dtype)


def norm(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    return layer_norm(x, ln.weight, ln.bias).to(dtype)


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


# the std of a standard normal cut at +-2: flax's variance_scaling divides
# by it, so that its truncated draw keeps the std it was asked for
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: a standard normal cut at +-2, scaled by
    ``fan_in^-0.5 / 0.8796``, so the draw's std is ``fan_in^-0.5``."""
    return trunc_normal_(t, fan_in**-0.5 / _TRUNC_STD, generator)


class Mlp(nn.Module):
    """fc1 → exact-erf GELU → fc2 (timm names); the JAX package computes it
    in XLA, outside any Pallas kernel (``models/vit.py:78-98``)."""

    def __init__(self, dim: int, hidden: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(F.gelu(dense(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class Attention(nn.Module):
    """qkv projection → multi-head attention → proj (timm names), with the
    JAX package's dispatch (``models/vit.py:101-143``): the fused-qkv kernel
    where ``use_packed`` says so, the three-input kernel where
    ``use_stacked_split`` does, else ``multi_head_attention`` on (B, H, L, d)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16,
                 attn_impl: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = validate_impl(attn_impl)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        h, impl = self.num_heads, self.attn_impl
        qkv = dense(x, self.qkv, self.dtype)
        if use_packed(B, L, D, h, qkv.dtype, impl, qkv.device):
            out = mha_natural_qkv(qkv, h)
        elif use_stacked_split(B, L, D, h, qkv.dtype, impl, qkv.device):
            out = mha_natural(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], h)
        else:
            q, k, v = qkv.reshape(B, L, 3, h, D // h).permute(2, 0, 3, 1, 4)
            out = multi_head_attention(q, k, v, impl).transpose(1, 2).reshape(B, L, D)
        return dense(out, self.proj, self.dtype)


def block_impl(impl: str) -> Optional[str]:
    """The block's route for ``attn_impl``: ``"split"`` (the branch
    kernels), ``"mono"`` (the whole-block kernel) or None (the sub-layer
    route, also for ``"chain"``: a single block never chains), as
    ``ops/block_pallas.py::block_impl`` decides."""
    validate_impl(impl)
    if impl == "block":
        return "mono"
    return "split" if impl in ("auto", "split", "split_pad") else None


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16, attn_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.route = block_impl(attn_impl)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, dtype, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def block_params(self):
        """The 12 tensors in the JAX package's ``_BLOCK_TREE`` order
        (``models/vit.py:213-220``), torch layouts."""
        a, m = self.attn, self.mlp
        return (self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
                a.proj.weight, a.proj.bias, self.norm2.weight, self.norm2.bias,
                m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        a, m = self.attn, self.mlp
        if self.route == "mono":
            return fused_block(x, self.block_params(), a.num_heads)
        if self.route is None:
            x = x + a(norm(x, self.norm1, self.dtype))
            return x + m(norm(x, self.norm2, self.dtype))
        x = fused_attn_branch(
            x, self.norm1.weight, self.norm1.bias,
            a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, a.num_heads,
        )
        return fused_mlp_branch(
            x, self.norm2.weight, self.norm2.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
        )


def run_block_stack(x: torch.Tensor, blocks, attn_impl: str = "auto") -> torch.Tensor:
    """The blocks in turn, or one chain where ``chain_impl`` says so
    (``attn_impl="chain"``, ``models/vit.py:234-301`` of the JAX package)."""
    if len(blocks):
        b0 = blocks[0]
        B, L, D = x.shape
        H, F_ = b0.attn.num_heads, b0.mlp.fc1.out_features
        if chain_impl(B, L, D, H, F_, len(blocks), attn_impl):
            return fused_block_chain(x.to(b0.dtype), [b.block_params() for b in blocks], H)
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
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
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
                 mlp_ratio: float = 4.0, dtype=torch.bfloat16, attn_impl: str = "auto"):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.num_patches = (img_size // patch_size) ** 2
        self.sequence_length = self.num_patches + 1
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.sequence_length, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype, attn_impl) for _ in range(depth)
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
        if use_fused_embed():
            # embed GEMM + CLS + pos + gather in one kernel: only the
            # (B, K, D) kept tokens reach device memory (ops/embed_fused.py)
            x = fused_patch_embed(patches, proj.weight.reshape(D, -1), proj.bias,
                                  self.cls_token, self.pos_embed, idx_keep)
        else:
            x = patches @ proj.weight.reshape(D, -1).to(dt).t() + proj.bias.to(dt)
            cls = self.cls_token.to(dt).expand(B, 1, D)
            x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
            if idx_keep is not None:
                x = get_at_index(x, idx_keep)
        x = run_block_stack(x, self.blocks, self.attn_impl)
        return norm(x, self.norm, dt)


def vit_from_config(model_cfg: dict, dtype=torch.bfloat16,
                    attn_impl: str = "auto") -> VisionTransformer:
    """Build a VisionTransformer from the reference YAML ``model`` section."""
    general = model_cfg.get("general", {})
    enc = model_cfg.get("encoder", {})
    return VisionTransformer(
        img_size=general.get("image_size", 96),
        patch_size=general.get("patch_size", 8),
        in_chans=general.get("in_chans", 3),
        embed_dim=enc.get("embed_dim", 144),
        depth=enc.get("depth", 4),
        num_heads=enc.get("num_heads", 6),
        dtype=dtype,
        attn_impl=attn_impl,
    )
