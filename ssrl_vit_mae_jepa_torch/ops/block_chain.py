"""A stack of N pre-LN transformer blocks as one CUDA entry per pass.

Port of ``ssrl_vit_mae_jepa_tpu/ops/block_chain.py::fused_block_chain``:

- forward: N × (attention branch, MLP branch), the split branches' function
  bit for bit (z rounded to bf16); in a graph it stashes, per block k, the
  attention output ``a_k``, the branch boundary ``x_mid_k`` and, for k ≥ 1,
  the block input ``x_in_k`` (3N − 1 (B, L, D) tensors); without one it
  stashes nothing (``_chain_fwd_only``, the no-grad forward);
- backward: the blocks in reverse with the gradient in f32 across every
  branch and block, rounded only as a GEMM operand and once at the end;
  the bias gradients of the branch outputs sum the f32 gradient.

On a CUDA tensor :func:`fused_block_chain` launches ``csrc/block_chain.cu``
through a ``torch.autograd.Function`` whose backward is a kernel too; on a
CPU tensor it runs :func:`chain_ref`, the plain version with the same
rounding points (and a backward of its own: autograd over a bf16 forward
would round the gradient at every branch boundary). No fallback: a CUDA
tensor the kernels do not take raises.

The TPU kernel keeps every block's weights and the gradient chain resident
in VMEM, and zero-pads a sub-lane D (the JEPA predictor's 96) to 128; both
are TPU layout devices. The port runs the function at the real D.
"""

from __future__ import annotations

import torch

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.ops.attention import validate_impl
from ssrl_vit_mae_jepa_torch.ops.block_fused import (
    _needs_grad,
    _route,
    _scale,
    _stream,
    _workspace,
    attn_bwd_plain,
    attn_fwd_plain,
    block_grad_floats,
    check_block,
    grad_views,
    mlp_bwd_plain,
    mlp_fwd_plain,
    pointers,
    prep12,
    supported,
)

#: kernel launches by wrapper entry; a wrapper adds one where it launches
LAUNCHES = {"chain_fwd": 0, "chain_fwd_nograd": 0, "chain_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def chain_impl(B: int, L: int, D: int, H: int, F: int, depth: int, impl: str) -> bool:
    """Whether the stack runs as one chain, as ``block_chain.chain_impl``
    decides: only when ``impl="chain"`` forces it (auto never takes it);
    forced, a depth below 2 or a shape beyond the kernels' fit
    (``block_fused.supported``, which also refuses ``D % H``) raises
    ``ValueError``."""
    validate_impl(impl)
    if impl != "chain":
        return False
    if depth < 2:
        raise ValueError("chain kernel needs depth >= 2")
    if not supported(B, L, D, H, F):
        raise ValueError(f"chain kernel unsupported for B={B} L={L} D={D} H={H} F={F}")
    return True


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _blocks(flat):
    return [flat[i:i + 12] for i in range(0, len(flat), 12)]


def chain_fwd_plain(x, params_list, num_heads):
    """The forward, and per block (x_in, a, x_mid): what the stash holds."""
    saved = []
    for p in params_list:
        x_mid, a = attn_fwd_plain(x, p[:6], num_heads)
        saved.append((x, a, x_mid))
        x = mlp_fwd_plain(x_mid, p[6:])
    return x, saved


def chain_bwd_plain(saved, params_list, g, num_heads):
    """(dx, per block its 12 gradients cast to each parameter's dtype), the
    gradient f32 from g to dx."""
    dt = saved[0][0].dtype
    gy = g.to(dt).float()
    grads = [None] * len(params_list)
    for k in reversed(range(len(params_list))):
        x_in, a, x_mid = saved[k]
        p = params_list[k]
        gy, gm = mlp_bwd_plain(x_mid, p[6:], gy, round_z=True)
        gy, ga = attn_bwd_plain(x_in, p[:6], a, gy, num_heads)
        grads[k] = [d.to(t.dtype) for d, t in zip(ga + gm, p)]
    return gy.to(dt), grads


class _ChainPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_heads, *flat):
        out, saved = chain_fwd_plain(x, _blocks(flat), num_heads)
        ctx.save_for_backward(*flat, *(t for trio in saved for t in trio))
        ctx.num_heads, ctx.n = num_heads, len(flat)
        return out

    @staticmethod
    def backward(ctx, g):
        ts = ctx.saved_tensors
        flat, rest = ts[:ctx.n], ts[ctx.n:]
        saved = [rest[i:i + 3] for i in range(0, len(rest), 3)]
        dx, grads = chain_bwd_plain(saved, _blocks(flat), g, ctx.num_heads)
        return (dx, None, *(d for blk in grads for d in blk))


def chain_ref(x, params_list, num_heads):
    """Plain N-block stack; ``params_list`` per block the 12 tensors in
    ``_BLOCK_TREE`` order, weights in torch Linear layout."""
    return _ChainPlain.apply(x, num_heads, *(t for p in params_list for t in p))


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------


def _fwd_cuda(x, kp, num_heads: int, stash: bool):
    """(out, the (3N - 1, B, L, D) stash or None); ``kp`` flat, 12 per block."""
    B, L, D = x.shape
    N, F_ = len(kp) // 12, kp[8].shape[0]
    lib = _build.load()
    out = torch.empty_like(x)
    st = x.new_empty((3 * N - 1, B, L, D)) if stash else None
    ws = _workspace(lib.ssrl_block_chain_fwd_workspace(B, L, D, F_, int(stash)), x)
    LAUNCHES["chain_fwd" if stash else "chain_fwd_nograd"] += 1
    _build.check(lib.ssrl_block_chain_fwd(
        x.data_ptr(), pointers(kp), out.data_ptr(), st.data_ptr() if stash else None,
        ws.data_ptr(), B, L, D, num_heads, F_, N, _scale(D, num_heads), _stream(x),
    ), "chain_fwd")
    return out, st


def _bwd_cuda(x, kp, st, g, num_heads: int):
    """(dx, per block its 12 f32 gradients)."""
    B, L, D = x.shape
    N, F_ = len(kp) // 12, kp[8].shape[0]
    lib = _build.load()
    dx = torch.empty_like(x)
    grads = torch.empty((N, block_grad_floats(D, F_)), dtype=torch.float32,
                        device=x.device)
    ws = _workspace(lib.ssrl_block_chain_bwd_workspace(B, L, D, F_), x)
    LAUNCHES["chain_bwd"] += 1
    _build.check(lib.ssrl_block_chain_bwd(
        x.data_ptr(), pointers(kp), st.data_ptr(), g.data_ptr(), dx.data_ptr(),
        grads.data_ptr(), ws.data_ptr(), B, L, D, num_heads, F_, N,
        _scale(D, num_heads), _stream(x),
    ), "chain_bwd")
    return dx, [grad_views(row, D, F_) for row in grads]


class _Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_heads, *flat):
        kp = [t for p in _blocks(flat) for t in prep12(p, x.dtype)]
        out, st = _fwd_cuda(x, kp, num_heads, stash=True)
        ctx.save_for_backward(x, st, *kp)
        ctx.num_heads = num_heads
        ctx.param_dtypes = [t.dtype for t in flat]
        return out

    @staticmethod
    def backward(ctx, g):
        x, st, *kp = ctx.saved_tensors
        dx, grads = _bwd_cuda(x, kp, st, g.to(x.dtype).contiguous(), ctx.num_heads)
        flat = [d for blk in grads for d in blk]
        return (dx, None, *(d.to(t) for d, t in zip(flat, ctx.param_dtypes)))


def fused_block_chain(x, params_list, num_heads):
    """N pre-LN blocks (``block_chain.fused_block_chain``): the kernels of
    ``csrc/block_chain.cu`` on CUDA, ``chain_ref`` on CPU. Without grad the
    CUDA forward stashes nothing."""
    params_list = [tuple(p) for p in params_list]
    if _route(x) == "cpu":
        return chain_ref(x, params_list, num_heads)
    for p in params_list:
        check_block(x, p, num_heads)
    x = x.contiguous()
    flat = [t for p in params_list for t in p]
    if _needs_grad(x, flat):
        return _Chain.apply(x, num_heads, *flat)
    kp = [t for p in params_list for t in prep12(p, x.dtype)]
    return _fwd_cuda(x, kp, num_heads, stash=False)[0]
