"""The two residual branches of a pre-LN transformer block, as CUDA kernels.

Port of the split-branch part of ``ssrl_vit_mae_jepa_tpu/ops/block_pallas.py``
(:477-862)::

    attn branch: x + bf16(MHA(bf16(LN1(x) Wqkv^T + bqkv)) Wp^T + bp)
    mlp branch:  x + bf16(fc2(bf16(GELU_erf(bf16(fc1(LN2(x)))))))

``fused_attn_branch`` / ``fused_mlp_branch`` are the wrappers the model
calls. On a CUDA tensor they launch the hand-written kernels of
``csrc/attn_branch.cu`` and ``csrc/mlp_branch.cu`` through a
``torch.autograd.Function`` whose backward is a kernel too; on a CPU tensor
they run the plain versions ``attn_branch_ref`` / ``mlp_branch_ref``, which
compute the same function with the same rounding points in tensor ops. There
is no fallback: a CUDA tensor the kernel does not take raises.

Numerics (``block_pallas.py:28-32``): LN statistics and softmax in f32, LN
eps 1e-6, products of rounded operands accumulated in f32, bf16 rounding of
y1, qkv, the scaled q, P, ``a``, the projection, z, h and the fc2 output;
weight and bias gradients in f32, cast to each parameter's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.ops.attention import mha_xla

LN_EPS = 1e-6

#: kernel launches by wrapper entry; a wrapper adds one where it launches
LAUNCHES = {
    "attn_branch_fwd": 0,
    "attn_branch_bwd": 0,
    "mlp_branch_fwd": 0,
    "mlp_branch_bwd": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def layer_norm(x, weight, bias):
    """f32 LayerNorm (eps 1e-6) of any-dtype ``x``; the caller rounds."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), LN_EPS)


def _dense(x, w, b):
    """f32-accumulated ``x W^T + b`` of operands rounded to x's dtype."""
    dt = x.dtype
    return x.float() @ w.to(dt).float().t() + b.to(dt).float()


def attn_branch_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads):
    """Plain attention branch; x (B, L, D), weights in torch Linear layout."""
    dt = x.dtype
    B, L, D = x.shape
    d = D // num_heads
    y1 = layer_norm(x, ln_scale, ln_bias).to(dt)
    qkv = _dense(y1, wqkv, bqkv).to(dt)
    q, k, v = qkv.reshape(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q = (q.float() * (1.0 / d**0.5)).to(dt)
    a = mha_xla(q, k, v, scale=1.0).transpose(1, 2).reshape(B, L, D)
    return x + _dense(a, wproj, bproj).to(dt)


def mlp_branch_ref(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Plain MLP branch with exact-erf GELU on the bf16-rounded z."""
    dt = x.dtype
    y2 = layer_norm(x, ln_scale, ln_bias).to(dt)
    z = _dense(y2, w1, b1).to(dt)
    h = F.gelu(z.float()).to(dt)
    return x + _dense(h, w2, b2).to(dt)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------


def _prep6(ln_s, ln_b, wa, ba, wb, bb, dt):
    """Kernel operands: f32 LN params, weights and biases in the compute
    dtype, contiguous (weights are cast per call, as ``_prep6`` does)."""
    f32 = [t.detach().float().contiguous() for t in (ln_s, ln_b)]
    return f32 + [t.detach().to(dt).contiguous() for t in (wa, ba, wb, bb)]


def _check_x(x: torch.Tensor, D: int) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the branch kernels take bfloat16 activations, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] != D:
        raise ValueError(f"expected (B, L, {D}) activations, got {tuple(x.shape)}")


def _check_params(params, shapes) -> None:
    for t, shape in zip(params, shapes):
        if t.device.type != "cuda" or tuple(t.shape) != shape:
            raise ValueError(
                f"branch parameter must be a CUDA tensor of shape {shape}, "
                f"got {tuple(t.shape)} on {t.device}"
            )


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _workspace(nbytes: int, x: torch.Tensor) -> torch.Tensor:
    return torch.empty(int(nbytes), dtype=torch.uint8, device=x.device)


def _attn_fwd_cuda(x, kp, num_heads: int, stash: bool):
    B, L, D = x.shape
    lib = _build.load()
    out = torch.empty_like(x)
    a = torch.empty_like(x) if stash else None
    ws = _workspace(lib.ssrl_attn_branch_fwd_workspace(B, L, D, int(stash)), x)
    LAUNCHES["attn_branch_fwd"] += 1
    _build.check(lib.ssrl_attn_branch_fwd(
        x.data_ptr(), *(p.data_ptr() for p in kp), out.data_ptr(),
        a.data_ptr() if stash else None, ws.data_ptr(),
        B, L, D, num_heads, 1.0 / (D // num_heads) ** 0.5, _stream(x),
    ), "attn_branch_fwd")
    return out, a


def _attn_bwd_cuda(x, kp, a, g, num_heads: int):
    B, L, D = x.shape
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dln3 = torch.empty((3, D), **f32)
    dwqkv = torch.empty((3 * D, D), **f32)
    dbqkv = torch.empty((3 * D,), **f32)
    dwp = torch.empty((D, D), **f32)
    ws = _workspace(lib.ssrl_attn_branch_bwd_workspace(B, L, D), x)
    s, b, wqkv, bqkv, wp, _ = kp
    LAUNCHES["attn_branch_bwd"] += 1
    _build.check(lib.ssrl_attn_branch_bwd(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wp.data_ptr(), a.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dln3.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(),
        dwp.data_ptr(), ws.data_ptr(),
        B, L, D, num_heads, 1.0 / (D // num_heads) ** 0.5, _stream(x),
    ), "attn_branch_bwd")
    # (d ln_s, d ln_b, d wqkv, d bqkv, d wp, d bp)
    return dx, (dln3[0], dln3[1], dwqkv, dbqkv, dwp, dln3[2])


def _mlp_fwd_cuda(x, kp):
    B, L, D = x.shape
    F_ = kp[2].shape[0]
    lib = _build.load()
    out = torch.empty_like(x)
    ws = _workspace(lib.ssrl_mlp_branch_fwd_workspace(B * L, D, F_), x)
    LAUNCHES["mlp_branch_fwd"] += 1
    _build.check(lib.ssrl_mlp_branch_fwd(
        x.data_ptr(), *(p.data_ptr() for p in kp), out.data_ptr(),
        ws.data_ptr(), B * L, D, F_, _stream(x),
    ), "mlp_branch_fwd")
    return out


def _mlp_bwd_cuda(x, kp, g):
    B, L, D = x.shape
    F_ = kp[2].shape[0]
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dln3 = torch.empty((3, D), **f32)
    dw1 = torch.empty((F_, D), **f32)
    db1 = torch.empty((F_,), **f32)
    dw2 = torch.empty((D, F_), **f32)
    ws = _workspace(lib.ssrl_mlp_branch_bwd_workspace(B * L, D, F_), x)
    s, b, w1, b1, w2, _ = kp
    LAUNCHES["mlp_branch_bwd"] += 1
    _build.check(lib.ssrl_mlp_branch_bwd(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), dln3.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), ws.data_ptr(),
        B * L, D, F_, _stream(x),
    ), "mlp_branch_bwd")
    # (d ln_s, d ln_b, d w1, d b1, d w2, d b2)
    return dx, (dln3[0], dln3[1], dw1, db1, dw2, dln3[2])


class _AttnBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wp, bp, num_heads):
        kp = _prep6(ln_s, ln_b, wqkv, bqkv, wp, bp, x.dtype)
        out, a = _attn_fwd_cuda(x, kp, num_heads, stash=True)
        ctx.save_for_backward(x, a, *kp)
        ctx.num_heads = num_heads
        ctx.param_dtypes = [t.dtype for t in (ln_s, ln_b, wqkv, bqkv, wp, bp)]
        return out

    @staticmethod
    def backward(ctx, g):
        x, a, *kp = ctx.saved_tensors
        dx, dparams = _attn_bwd_cuda(
            x, kp, a, g.to(x.dtype).contiguous(), ctx.num_heads
        )
        return (dx, *(d.to(t) for d, t in zip(dparams, ctx.param_dtypes)), None)


class _MlpBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w1, b1, w2, b2):
        kp = _prep6(ln_s, ln_b, w1, b1, w2, b2, x.dtype)
        ctx.save_for_backward(x, *kp)
        ctx.param_dtypes = [t.dtype for t in (ln_s, ln_b, w1, b1, w2, b2)]
        return _mlp_fwd_cuda(x, kp)

    @staticmethod
    def backward(ctx, g):
        x, *kp = ctx.saved_tensors
        dx, dparams = _mlp_bwd_cuda(x, kp, g.to(x.dtype).contiguous())
        return (dx, *(d.to(t) for d, t in zip(dparams, ctx.param_dtypes)))


def _needs_grad(x, params) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params)
    )


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no branch implementation for device {x.device}")
    return x.device.type


def fused_attn_branch(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads):
    """x + proj(MHA(LN1(x) Wqkv^T + bqkv)): kernels on CUDA, plain on CPU.

    Without grad the CUDA forward stashes no attention output ``a`` (the
    no-grad primal of ``block_pallas._fused_attn_branch``)."""
    params = (ln_scale, ln_bias, wqkv, bqkv, wproj, bproj)
    if _route(x) == "cpu":
        return attn_branch_ref(x, *params, num_heads)
    D = x.shape[-1]
    _check_x(x, D)
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    _check_params(params, [(D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,)])
    x = x.contiguous()
    if _needs_grad(x, params):
        return _AttnBranch.apply(x, *params, num_heads)
    return _attn_fwd_cuda(x, _prep6(*params, x.dtype), num_heads, stash=False)[0]


def fused_mlp_branch(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """x + fc2(GELU(fc1(LN2(x)))): kernels on CUDA, plain on CPU."""
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    if _route(x) == "cpu":
        return mlp_branch_ref(x, *params)
    D = x.shape[-1]
    F_ = w1.shape[0]
    _check_x(x, D)
    _check_params(params, [(D,), (D,), (F_, D), (F_,), (D, F_), (D,)])
    x = x.contiguous()
    if _needs_grad(x, params):
        return _MlpBranch.apply(x, *params)
    return _mlp_fwd_cuda(x, _prep6(*params, x.dtype))
