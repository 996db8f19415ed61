"""Fused patch-embed prologue: embed GEMM + CLS + position embedding + token
gather, as one CUDA kernel.

Port of ``ssrl_vit_mae_jepa_tpu/ops/embed_pallas.py``::

    out = ([cls + pos[0]; patches W^T + b + pos[1:]])[idx_keep]

``fused_patch_embed`` is the wrapper the ViT calls. On a CUDA tensor it
launches the hand-written kernels of ``csrc/patch_embed.cu`` (bf16 patches)
or ``csrc/patch_embed_f32.cu`` (f32 patches, where every rounding point below
is a no-op) through a ``torch.autograd.Function`` whose backward is a kernel
too; on a CPU tensor it runs the plain version ``fused_patch_embed_ref``.
There is no fallback: a CUDA tensor the kernels do not take raises.

Rounding points (``embed_pallas.py:105-115, 178-182``): the CLS token is
folded into row 0 of the position embedding in f32 and rounded once; the
other rows are ``bf16(bf16(P W^T + bf16(b)) + bf16(pos))``, the product of
rounded operands accumulated in f32. The unfused chain of ``models/vit.py``
rounds ``cls`` and ``pos[0]`` separately, so row 0 may differ by one ulp.

The backward sums the gradient of repeated indices, as the TPU kernel's
one-hot transpose does (every caller passes unique indices). Weight and
bias gradients are f32, cast to each parameter's dtype.

``SSRL_FUSED_EMBED`` (read at every call) switches the ViT to this route:
``1`` or ``force``; anything else keeps the unfused chain.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.ops.block_fused import dtype_key
from ssrl_vit_mae_jepa_torch.ops.masking import get_at_index

#: kernel launches by wrapper entry; a wrapper adds one where it launches
LAUNCHES = {"patch_embed_fwd": 0, "patch_embed_bwd": 0,
            "patch_embed_fwd_f32": 0, "patch_embed_bwd_f32": 0}

# the kernels' limits (csrc/patch_embed.cu and patch_embed_f32.cu: shape_ok);
# D and Pc bound the weight the bf16 kernels keep in shared memory
MAX_TOKENS, MAX_KEPT, MAX_WIDTH = 256, 1024, 256


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_fused_embed() -> bool:
    """The dispatch switch of ``embed_pallas.py:82-91`` without its TPU
    guards: True when ``SSRL_FUSED_EMBED`` is ``1`` or ``force``."""
    return os.environ.get("SSRL_FUSED_EMBED", "0") in ("1", "force")


def _cls_pos(cls: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(L, D) f32: the position embedding with the CLS token added to row 0."""
    D = pos.shape[-1]
    posf = pos.reshape(-1, D).float()
    pad = torch.zeros(posf.shape[0] - 1, D, dtype=posf.dtype, device=posf.device)
    return posf + torch.cat([cls.reshape(1, D).float(), pad])


def fused_patch_embed_ref(patches, w, b, cls, pos, idx_keep=None):
    """Plain version: (B, N, Pc) patches → (B, K, D) tokens in patches' dtype.

    ``w`` (D, Pc) and ``b`` (D,) are the embedding in torch Linear layout,
    ``cls`` (1, 1, D), ``pos`` (1, L, D) with L = N + 1, ``idx_keep`` (B, K)
    token indices or None (K = L)."""
    dt = patches.dtype
    B = patches.shape[0]
    emb = (patches.float() @ w.to(dt).float().t() + b.to(dt).float()).to(dt)
    cp = _cls_pos(cls, pos)
    rest = (emb.float() + cp[1:].to(dt).float()).to(dt)
    full = torch.cat([cp[:1].to(dt).expand(B, 1, -1), rest], dim=1)
    return full if idx_keep is None else get_at_index(full, idx_keep)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(patches, w, b, cls, pos, idx_keep) -> None:
    if patches.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the patch-embed kernels take bfloat16 or float32 patches, got "
                        f"{patches.dtype}")
    if patches.dim() != 3:
        raise ValueError(f"expected (B, N, Pc) patches, got {tuple(patches.shape)}")
    B, N, Pc = patches.shape
    D = w.shape[0]
    L = N + 1
    shapes = [(w, (D, Pc)), (b, (D,)), (cls, (1, 1, D)), (pos, (1, L, D))]
    for t, shape in shapes:
        if t.device.type != "cuda" or tuple(t.shape) != shape:
            raise ValueError(f"patch-embed operand must be a CUDA tensor of shape "
                             f"{shape}, got {tuple(t.shape)} on {t.device}")
    K = L
    if idx_keep is not None:
        if (idx_keep.device.type != "cuda" or idx_keep.dim() != 2
                or idx_keep.shape[0] != B or idx_keep.dtype != torch.int64):
            raise ValueError(f"idx_keep must be a (B, K) int64 CUDA tensor, got "
                             f"{tuple(idx_keep.shape)} {idx_keep.dtype} on {idx_keep.device}")
        K = idx_keep.shape[1]
    if (L > MAX_TOKENS or not 1 <= K <= MAX_KEPT or Pc % 8 or D % 8
            or not (8 <= Pc <= MAX_WIDTH and 8 <= D <= MAX_WIDTH)):
        raise ValueError(f"the patch-embed kernel takes L <= {MAX_TOKENS}, "
                         f"1 <= K <= {MAX_KEPT} and Pc, D multiples of 8 from 8 to "
                         f"{MAX_WIDTH}; got L={L}, K={K}, Pc={Pc}, D={D}")


def _operands(w, b, cls, pos, dt):
    """Kernel operands: weight and bias in the patches' dtype ``dt``, f32 CLS
    and position rows."""
    D = w.shape[0]
    return (w.detach().to(dt).contiguous(),
            b.detach().to(dt).contiguous(),
            cls.detach().float().reshape(D).contiguous(),
            pos.detach().float().reshape(-1, D).contiguous())


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_cuda(patches, kw, kb, kcls, kpos, idx):
    B, N, Pc = patches.shape
    D = kw.shape[0]
    K = N + 1 if idx is None else idx.shape[1]
    out = torch.empty((B, K, D), dtype=patches.dtype, device=patches.device)
    key = dtype_key(patches.dtype, "patch_embed_fwd")
    LAUNCHES[key] += 1
    _build.check(getattr(_build.load(), f"ssrl_{key}")(
        patches.data_ptr(), kw.data_ptr(), kb.data_ptr(), kcls.data_ptr(),
        kpos.data_ptr(), _ptr(idx), out.data_ptr(), B, N, Pc, D, K, _stream(patches),
    ), key)
    return out


def _bwd_cuda(patches, kw, idx, g, want_dpatches: bool):
    B, N, Pc = patches.shape
    D = kw.shape[0]
    L = N + 1
    K = L if idx is None else idx.shape[1]
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=patches.device)
    dpatches = torch.empty_like(patches) if want_dpatches else None
    dw = torch.empty((D, Pc), **f32)
    db = torch.empty((D,), **f32)
    dcp = torch.empty((L, D), **f32)
    key = dtype_key(patches.dtype, "patch_embed_bwd")
    ws_bytes = getattr(lib, f"ssrl_{key}_workspace")(B, N, Pc, D, K, int(idx is not None))
    ws = torch.empty(int(ws_bytes), dtype=torch.uint8, device=patches.device)
    LAUNCHES[key] += 1
    _build.check(getattr(lib, f"ssrl_{key}")(
        patches.data_ptr(), kw.data_ptr(), _ptr(idx), g.data_ptr(), _ptr(dpatches),
        dw.data_ptr(), db.data_ptr(), dcp.data_ptr(), ws.data_ptr(),
        B, N, Pc, D, K, _stream(patches),
    ), key)
    return dpatches, dw, db, dcp


class _PatchEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, patches, w, b, cls, pos, idx_keep):
        kw, kb, kcls, kpos = _operands(w, b, cls, pos, patches.dtype)
        ctx.save_for_backward(patches, kw, idx_keep)
        ctx.param_meta = [(t.dtype, t.shape) for t in (w, b, cls, pos)]
        return _fwd_cuda(patches, kw, kb, kcls, kpos, idx_keep)

    @staticmethod
    def backward(ctx, g):
        patches, kw, idx = ctx.saved_tensors
        dpatches, dw, db, dcp = _bwd_cuda(
            patches, kw, idx, g.to(patches.dtype).contiguous(), ctx.needs_input_grad[0]
        )
        # cls rides in row 0 of cls_pos, pos in every row
        grads = [dw, db, dcp[:1], dcp]
        return (dpatches, *(d.reshape(s).to(t) for d, (t, s) in zip(grads, ctx.param_meta)),
                None)


def fused_patch_embed(patches, w, b, cls, pos, idx_keep=None):
    """(B, N, Pc) patches → (B, K, D) tokens: kernels on CUDA, plain on CPU.

    Arguments as ``fused_patch_embed_ref``. Without grad the CUDA route
    launches the forward kernel alone."""
    if patches.device.type == "cpu":
        return fused_patch_embed_ref(patches, w, b, cls, pos, idx_keep)
    if patches.device.type != "cuda":
        raise ValueError(f"no patch-embed implementation for device {patches.device}")
    _check(patches, w, b, cls, pos, idx_keep)
    patches = patches.contiguous()
    idx = None if idx_keep is None else idx_keep.contiguous()
    params = (w, b, cls, pos)
    if torch.is_grad_enabled() and (patches.requires_grad or any(p.requires_grad for p in params)):
        return _PatchEmbed.apply(patches, w, b, cls, pos, idx)
    return _fwd_cuda(patches, *_operands(*params, patches.dtype), idx)
