"""Multi-head attention: the plain path and the dispatch to the kernels.

Port of ``ssrl_vit_mae_jepa_tpu/ops/attention.py``. ``mha_xla`` is the plain
path: f32 scores and softmax, probabilities rounded to the input dtype
before PV, the PV product accumulated in f32 and rounded once. The policies
``use_packed``, ``use_stacked_split`` and ``multi_head_attention`` keep the
JAX package's semantics, with two substitutions: "on the TPU" becomes "the
tensor is on a CUDA device", and the kernels' VMEM ``supported`` becomes the
fit of ``csrc/mha.cu`` (``attention_core.fits``: L <= 256, d <= 32, which
``csrc/mha_f32.cu`` takes too). A forced ``"packed"`` or ``"pallas"`` on a
shape the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ssrl_vit_mae_jepa_torch.ops.attention_core import fits
from ssrl_vit_mae_jepa_torch.ops.attention_heads import mha_pallas
from ssrl_vit_mae_jepa_torch.ops.attention_stacked import mha_stacked, mha_stacked_qkv

#: every attn_impl string any layer understands; a typo'd impl raises rather
#: than behaving as "auto"
KNOWN_IMPLS = frozenset(
    {"auto", "xla", "pallas", "packed", "stacked", "block", "split",
     "split_pad", "chain"}
)


def validate_impl(impl: str) -> str:
    if impl not in KNOWN_IMPLS:
        raise ValueError(
            f"unknown attn_impl {impl!r}; expected one of {sorted(KNOWN_IMPLS)}"
        )
    return impl


def _on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def supported(L: int, d: int, dtype) -> bool:
    """Whether the attention kernels take this shape and dtype."""
    return dtype in (torch.bfloat16, torch.float32) and fits(L, d)


def mha_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, L, d) tensors → (B, H, L, d); ``scale``
    defaults to d^-½ (pass 1.0 for queries that are already scaled)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def use_packed(B: int, L: int, D: int, num_heads: int, dtype, impl: str,
               device) -> bool:
    """Whether attention takes the fused-qkv kernel (``mha_stacked_qkv``).

    ``"packed"`` forces it and raises where it does not fit; auto and
    ``"stacked"`` take it on a CUDA device at D ≥ 128 with head dim ≥ 24,
    the JAX package's policy (its D < 128 exclusion is a TPU fault class,
    kept so that the routes agree)."""
    if impl in ("xla", "pallas"):
        return False
    ok = D % num_heads == 0 and supported(L, D // num_heads, dtype)
    if impl == "packed":
        if not ok:
            raise ValueError(
                f"fused attention unsupported for B={B} L={L} D={D} H={num_heads}"
            )
        return True
    if D < 128 or D // num_heads < 24:
        return False
    return ok and _on_cuda(device)


def use_stacked_split(B: int, L: int, D: int, num_heads: int, dtype, impl: str,
                      device) -> bool:
    """Auto only: the three-input kernel (``mha_stacked``) for D < 128 on a
    CUDA device, e.g. the JEPA predictor (L=145, D=96, d=16)."""
    if impl != "auto" or D >= 128:
        return False
    ok = D % num_heads == 0 and supported(L, D // num_heads, dtype)
    return ok and _on_cuda(device)


def mha_natural(q, k, v, num_heads: int):
    """Attention on three natural (B, L, D) tensors."""
    return mha_stacked(q, k, v, num_heads)


def mha_natural_qkv(qkv, num_heads: int):
    """Attention on the fused (B, L, 3D) qkv tensor."""
    return mha_stacked_qkv(qkv, num_heads)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """Dispatch attention over (B, H, L, d) tensors: ``"pallas"`` forces the
    per-head kernel (raising where it does not fit); auto takes it on a CUDA
    device for L ≥ 64; everything else is ``mha_xla``."""
    if impl == "xla":
        return mha_xla(q, k, v)
    B, H, L, d = q.shape
    if impl in ("pallas", "auto"):
        worth_it = impl == "pallas" or L >= 64
        if supported(L, d, q.dtype) and worth_it and (_on_cuda(q.device) or impl == "pallas"):
            return mha_pallas(q, k, v)
        if impl == "pallas":
            raise ValueError(
                f"pallas attention unsupported for shape B={B} H={H} L={L} d={d}"
            )
    return mha_xla(q, k, v)
