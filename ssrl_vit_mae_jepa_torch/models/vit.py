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

Over a model axis (``shard_blocks_``, the JAX package's tensor-parallel
``model`` axis) every block holds its shard of ``parallel/mesh.py``'s
Megatron layout in its own parameters (the q, k, v rows and proj columns of
H/mp heads, an F/mp slice of fc1 and fc2) and runs the branch route through
``fused_attn_branch_tp`` / ``fused_mlp_branch_tp``, or the ``xla`` sub-layer
route through ``parallel/tensor.py``'s operators. The whole-block, chain and
attention-kernel routes raise there, as the JAX package refuses them (a
Mosaic kernel cannot be partitioned automatically,
``training/tasks.py:86-99`` there).
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
    fused_attn_branch_tp,
    fused_block,
    fused_mlp_branch,
    fused_mlp_branch_tp,
    layer_norm,
)
from ssrl_vit_mae_jepa_torch.ops.embed_fused import fused_patch_embed, use_fused_embed
from ssrl_vit_mae_jepa_torch.ops.masking import get_at_index
from ssrl_vit_mae_jepa_torch.ops.patches import patchify
from ssrl_vit_mae_jepa_torch.parallel.mesh import ModelAxis, shard_spec, shard_tensor
from ssrl_vit_mae_jepa_torch.parallel.tensor import copy_to_model, reduce_from_model


def dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """``nn.Dense(dtype)``'s promote-then-matmul: cast, matmul, add bias."""
    return x.to(dtype) @ lin.weight.to(dtype).t() + lin.bias.to(dtype)


def norm(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    return layer_norm(x, ln.weight, ln.bias).to(dtype)


def row_parallel(x: torch.Tensor, lin: nn.Linear, tp: ModelAxis, dtype) -> torch.Tensor:
    """A row-parallel ``dense`` of a shard: its f32 partial product, summed
    over the model group (``reduce_from_model``), then the full bias, rounded
    once to ``dtype``."""
    part = x.to(dtype).float() @ lin.weight.to(dtype).float().t()
    return (reduce_from_model(part, tp) + lin.bias.to(dtype).float()).to(dtype)


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
        self.hidden = hidden
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        #: the model axis this layer's F/mp slice is of (``Block.shard_``)
        self.tp: Optional[ModelAxis] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:  # column-parallel fc1, row-parallel fc2
            h = F.gelu(dense(copy_to_model(x, self.tp), self.fc1, self.dtype))
            return row_parallel(h, self.fc2, self.tp, self.dtype)
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
        #: the model axis this layer's heads are split over (``Block.shard_``)
        self.tp: Optional[ModelAxis] = None

    @property
    def local_heads(self) -> int:
        """The heads this rank holds: H, or H/mp over a model axis."""
        return self.num_heads // (1 if self.tp is None else self.tp.size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        h, impl = self.num_heads, self.attn_impl
        if self.tp is not None:  # the xla route over a model axis: local heads
            h = self.local_heads
            qkv = dense(copy_to_model(x, self.tp), self.qkv, self.dtype)
            Da = qkv.shape[-1] // 3
            q, k, v = qkv.reshape(B, L, 3, h, Da // h).permute(2, 0, 3, 1, 4)
            out = multi_head_attention(q, k, v, "xla").transpose(1, 2).reshape(B, L, Da)
            return row_parallel(out, self.proj, self.tp, self.dtype)
        qkv = dense(x, self.qkv, self.dtype)
        if use_packed(B, L, D, h, qkv.dtype, impl, qkv.device):
            out = mha_natural_qkv(qkv, h)
        elif use_stacked_split(B, L, D, h, qkv.dtype, impl, qkv.device):
            out = mha_natural(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], h)
        else:
            q, k, v = qkv.reshape(B, L, 3, h, D // h).permute(2, 0, 3, 1, 4)
            out = multi_head_attention(q, k, v, impl).transpose(1, 2).reshape(B, L, D)
        return dense(out, self.proj, self.dtype)


#: attn_impl -> why it cannot run over a model axis (the JAX package's
#: Mosaic kernels cannot be partitioned automatically either)
_TP_REFUSED = {
    "block": "the whole-block kernel",
    "chain": "the block-chain kernel",
    "packed": "the fused-qkv attention kernel",
    "pallas": "the per-head attention kernel",
    "stacked": "the head-stacked attention kernel",
}


def check_tp_route(impl: str) -> None:
    """Raise where ``attn_impl`` names a route that cannot be split over a
    model axis; the branch route (auto, split, split_pad) and the ``xla``
    sub-layer route can."""
    validate_impl(impl)
    if impl in _TP_REFUSED:
        raise ValueError(
            f"attn_impl={impl!r} ({_TP_REFUSED[impl]}) cannot run under "
            f"model_parallel > 1: a kernel over a whole layer is not partitioned "
            f"(the JAX package refuses it too); use auto, split, split_pad or xla")


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
        #: the model axis of this block's shard (``shard_``); None: whole
        self.tp: Optional[ModelAxis] = None

    def check_tp(self, mp: int) -> None:
        """Raise unless this block splits over ``mp`` model ranks: its route
        (``check_tp_route``), its heads and its hidden units."""
        check_tp_route(self.attn.attn_impl)
        H, F_ = self.attn.num_heads, self.mlp.hidden
        if H % mp or F_ % mp:
            raise ValueError(f"a block of {H} heads and {F_} hidden units does not split "
                             f"over model_parallel={mp}")

    def shard_(self, axis: ModelAxis) -> None:
        """Keep only ``axis.rank``'s shard of the full weights, in place (the
        Parameter objects stay, their data shrinks)."""
        self.check_tp(axis.size)
        for name, p in self.named_parameters():
            p.data = shard_tensor(p.data, shard_spec(name), axis)
        self.tp = self.attn.tp = self.mlp.tp = axis

    def unshard_(self) -> None:
        """Full-size zero weights again and no model axis (for a new init:
        the values are not kept)."""
        if self.tp is None:
            return
        for name, p in self.named_parameters():
            spec = shard_spec(name)
            if spec is not None:
                shape = list(p.shape)
                shape[spec.dim] *= self.tp.size
                p.data = torch.zeros(shape, dtype=p.dtype, device=p.device)
        self.tp = self.attn.tp = self.mlp.tp = None

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
        if self.tp is not None and self.route == "split":
            x = fused_attn_branch_tp(
                x, self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
                a.proj.weight, a.proj.bias, a.local_heads, self.tp,
            )
            return fused_mlp_branch_tp(
                x, self.norm2.weight, self.norm2.bias,
                m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias, self.tp,
            )
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
    (``attn_impl="chain"``, ``models/vit.py:234-301`` of the JAX package);
    a block split over a model axis never chains (``Block.check_tp``)."""
    if len(blocks):
        b0 = blocks[0]
        B, L, D = x.shape
        H, F_ = b0.attn.num_heads, b0.mlp.fc1.out_features
        if chain_impl(B, L, D, H, F_, len(blocks), attn_impl):
            return fused_block_chain(x.to(b0.dtype), [b.block_params() for b in blocks], H)
    for blk in blocks:
        x = blk(x)
    return x


def shard_blocks_(module: nn.Module, axis: Optional[ModelAxis]) -> None:
    """Split every ``Block`` under ``module`` over the model ``axis`` (the
    MAE encoder and decoder, the JEPA context encoder and predictor, the
    classifier's encoder), in place; a trivial axis does nothing. Every
    block is checked before any is cut."""
    if axis is None or axis.size == 1:
        return
    check_tp_blocks(module, axis.size)
    for m in module.modules():
        if isinstance(m, Block):
            m.shard_(axis)


def unshard_blocks_(module: nn.Module) -> None:
    """Every ``Block`` under ``module`` back to full-size (zero) weights."""
    for m in module.modules():
        if isinstance(m, Block):
            m.unshard_()


def check_tp_blocks(module: nn.Module, mp: int) -> None:
    """Raise unless every ``Block`` under ``module`` splits over ``mp``."""
    if mp > 1:
        for m in module.modules():
            if isinstance(m, Block):
                m.check_tp(mp)


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
