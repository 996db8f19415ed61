"""A pre-LN transformer block as CUDA kernels: its two residual branches,
and the whole block.

Port of ``ssrl_vit_mae_jepa_tpu/ops/block_pallas.py``::

    attn branch: x + bf16(MHA(bf16(LN1(x) Wqkv^T + bqkv)) Wp^T + bp)
    mlp branch:  x + bf16(fc2(bf16(GELU_erf(bf16(fc1(LN2(x)))))))
    whole block: the two in turn, with z = fc1(LN2(x)) kept in f32

``fused_attn_branch`` / ``fused_mlp_branch`` (the split branches, :477-862)
and ``fused_block`` (the whole block, :389-474) are the wrappers the model
calls. On a CUDA tensor they launch the hand-written kernels of
``csrc/attn_branch.cu``, ``csrc/mlp_branch.cu`` and ``csrc/fused_block.cu``
(whose MLP half, like the chain's, is one kernel each way in
``csrc/block_mlp.cu``, alone ``mlp_half`` / ``mlp_half_bwd``; at f32
``csrc/branch_f32.cu`` and ``csrc/fused_block_f32.cu``) through a
``torch.autograd.Function`` whose backward is a kernel too; on a CPU tensor
they run the plain versions ``attn_branch_ref`` / ``mlp_branch_ref`` /
``block_ref``, which compute the same function with the
same rounding points in tensor ops. There is no fallback: a CUDA tensor the
kernel does not take raises.

Every kernel also takes f32 activations (the JAX kernels' f32
instantiation: an f32 model's training step, and the feature and
reconstruction entry points): the split branches ``csrc/branch_f32.cu``,
forward with or without the stash and backward, and the whole block
``csrc/fused_block_f32.cu`` (and the chain of ``ops/block_chain.py``) built
on the same f32 branch sequences (``csrc/branch_f32.cuh``); f32 throughout
with no rounding point, so their plain versions are the bf16 ones at f32.
The f32 MLP half as one kernel each way (``csrc/block_mlp_f32.cu``) runs
alone, as ``mlp_half`` / ``mlp_half_bwd`` on f32 tensors.

Numerics (``block_pallas.py:28-32``): LN statistics and softmax in f32, LN
eps 1e-6, products of rounded operands accumulated in f32, bf16 rounding of
y1, qkv, the scaled q, P, ``a``, the projection, z, h and the fc2 output;
weight and bias gradients in f32, cast to each parameter's dtype. The whole
block rounds elsewhere (``block_pallas.py:256-317``): z stays f32 into the
GELU, and its backward keeps the gradient between the branches in f32,
rounded only as a GEMM operand, so ``block_ref`` has a backward of its own
(autograd over a bf16 forward would round it at the branch boundary).

Split over a model axis (``parallel/mesh.py``'s Megatron layout: a rank
holds the qkv rows and proj columns of H/mp heads and an F/mp slice of fc1
and fc2), ``fused_attn_branch_tp`` / ``fused_mlp_branch_tp`` run a branch as
three steps: the partial kernel (LN at D, the rest at the shard's widths,
proj or fc2 ending in its f32 sum without bias or residual), the all-reduce
of that sum over the model group, and the finish kernel (``x + round(sum +
b)``, the bias-residual epilogue's rounding points). Their backward runs
the partial backward (the shard's weight gradients and its f32 part of the
LN output's gradient), the all-reduce of that part, and the LN backward,
whose dx and LN and bias gradients come out equal on every model rank. So
a split block equals the whole one up to f32 summation order. On the CPU
the plain versions ``attn_branch_tp_ref`` / ``mlp_branch_tp_ref`` run the
same function with ``parallel/tensor.py``'s operators.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

import torch.distributed as dist

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.ops.attention import mha_xla
from ssrl_vit_mae_jepa_torch.ops.attention_core import fits, heads_of, plain_bwd_f32
from ssrl_vit_mae_jepa_torch.parallel.tensor import copy_to_model, reduce_from_model

LN_EPS = 1e-6
#: the activation dtypes every kernel takes on the card
_DTYPES = (torch.bfloat16, torch.float32)

#: kernel launches by wrapper entry; a wrapper adds one where it launches
LAUNCHES = {
    "attn_branch_fwd": 0,
    "attn_branch_fwd_nograd": 0,  # the no-stash forward (no-grad callers)
    "attn_branch_bwd": 0,
    "mlp_branch_fwd": 0,
    "mlp_branch_bwd": 0,
    "block_fwd": 0,         # the whole block, in a graph
    "block_fwd_nograd": 0,  # the same kernel for no-grad callers
    "block_bwd": 0,
    # the MLP half's kernels of csrc/block_mlp.cu: one a bf16 whole block,
    # N a bf16 chain of N blocks (each way), or one a call of ``mlp_half*``
    "mlp_half_fwd": 0,
    "mlp_half_bwd": 0,
    # the f32 MLP half (csrc/block_mlp_f32.cu): one a call of ``mlp_half*`` alone
    "mlp_half_fwd_f32": 0,
    "mlp_half_bwd_f32": 0,
    "gemm": 0,  # the GEMM alone (``gemm``), for its own checks; never on a step
    "gemm_f32": 0,  # the f32 GEMM alone (``gemm`` at f32), likewise
    "attn_branch_fwd_f32": 0,  # csrc/branch_f32.cu: the f32 branches
    "attn_branch_fwd_nograd_f32": 0,
    "attn_branch_bwd_f32": 0,
    "mlp_branch_fwd_f32": 0,  # with and without grad: the same kernel
    "mlp_branch_bwd_f32": 0,
    "block_fwd_f32": 0,  # csrc/fused_block_f32.cu: the f32 whole block
    "block_fwd_nograd_f32": 0,
    "block_bwd_f32": 0,
    # split over a model axis: the partial kernels, the finish, the LN backward
    "attn_branch_part_fwd": 0,
    "attn_branch_part_fwd_nograd": 0,
    "attn_branch_part_bwd": 0,
    "mlp_branch_part_fwd": 0,  # with and without grad: the same kernel
    "mlp_branch_part_bwd": 0,
    "branch_finish": 0,
    "branch_ln_bwd": 0,
    "attn_branch_part_fwd_f32": 0,
    "attn_branch_part_fwd_nograd_f32": 0,
    "attn_branch_part_bwd_f32": 0,
    "mlp_branch_part_fwd_f32": 0,
    "mlp_branch_part_bwd_f32": 0,
    "branch_finish_f32": 0,
    "branch_ln_bwd_f32": 0,
    # the LN backward's four bf16 instantiations alone (``ln_bwd``), for
    # their checks; never on a step
    "ln_bwd": 0,
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


def attn_fwd_plain(x, p, num_heads):
    """The attention branch of ``p`` = (ln_s, ln_b, wqkv, bqkv, wproj,
    bproj): (x + proj, the attention output ``a``)."""
    ln_scale, ln_bias, wqkv, bqkv, wproj, bproj = p
    dt = x.dtype
    B, L, D = x.shape
    d = D // num_heads
    y1 = layer_norm(x, ln_scale, ln_bias).to(dt)
    qkv = _dense(y1, wqkv, bqkv).to(dt)
    q, k, v = qkv.reshape(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q = (q.float() * (1.0 / d**0.5)).to(dt)
    a = mha_xla(q, k, v, scale=1.0).transpose(1, 2).reshape(B, L, D)
    return x + _dense(a, wproj, bproj).to(dt), a


def mlp_fwd_plain(x, p, round_z: bool = True):
    """The MLP branch of ``p`` = (ln_s, ln_b, w1, b1, w2, b2), exact-erf
    GELU on z rounded to x's dtype (``round_z``) or in f32."""
    ln_scale, ln_bias, w1, b1, w2, b2 = p
    dt = x.dtype
    y2 = layer_norm(x, ln_scale, ln_bias).to(dt)
    z = _dense(y2, w1, b1)
    if round_z:
        z = z.to(dt)
    h = F.gelu(z.float()).to(dt)
    return x + _dense(h, w2, b2).to(dt)


def attn_branch_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads):
    """Plain attention branch; x (B, L, D), weights in torch Linear layout."""
    return attn_fwd_plain(x, (ln_scale, ln_bias, wqkv, bqkv, wproj, bproj), num_heads)[0]


def mlp_branch_ref(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Plain MLP branch with exact-erf GELU on the bf16-rounded z."""
    return mlp_fwd_plain(x, (ln_scale, ln_bias, w1, b1, w2, b2))


# ---------------------------------------------------------------------------
# Plain backward of a branch from an f32 residual gradient (the whole block,
# and the chain of ops/block_chain.py): the kernels' rounding points
# ---------------------------------------------------------------------------


def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _tn(a, b):
    """aᵀ b over the rows, f32: the weight gradient in torch layout."""
    return _rows(a).float().t() @ _rows(b).float()


def _gelu_grad(z):
    """d gelu / dz = Φ(z) + z·φ(z), f32."""
    return (0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
            + z * torch.exp(-0.5 * z * z) * 0.3989422804014327)


# ---------------------------------------------------------------------------
# The branch kernels' GEMM (csrc/gemm.cuh, csrc/gemm_sm90.cuh): every product
# of the branch sequences is one of these, and each epilogue is a rounding
# contract that the plain branch versions above and below follow.
# ---------------------------------------------------------------------------

#: layout -> the epilogues it takes (``ssrl::gemm``); the numbers are ``ssrl::Epi``
GEMM_EPIS = {
    "nt": ("bias_bf16", "bias_resid", "bias_gelu", "bias_gelu32"),
    "nn": ("bf16", "f32", "gelu_bwd", "gelu32_bwd"),
    "tn": ("f32",),
}
_EPI_CODE = {"f32": 0, "bf16": 1, "bias_bf16": 2, "bias_resid": 3, "bias_gelu": 4,
             "gelu_bwd": 5, "bias_gelu32": 6, "gelu32_bwd": 7}
_LAYOUT_CODE = {"nt": 0, "nn": 1, "tn": 2}


def _gemm_dims(a, b, layout: str):
    """(M, N, K) of the product, from the operands' shapes: nt a (M, K) b
    (N, K); nn a (M, K) b (K, N); tn a (K, M) b (K, N)."""
    if layout not in GEMM_EPIS:
        raise ValueError(f"unknown GEMM layout {layout!r}; expected one of {list(GEMM_EPIS)}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("the GEMM takes 2-D operands")
    if layout == "nt":
        (M, K), (N, K2) = a.shape, b.shape
    elif layout == "nn":
        (M, K), (K2, N) = a.shape, b.shape
    else:
        (K, M), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"{layout} operands disagree on K: {tuple(a.shape)}, {tuple(b.shape)}")
    return M, N, K


def gemm_ref(a, b, layout: str, epi: str, bias=None, resid=None, z=None):
    """Plain version of one product of the branch GEMM, f32-accumulated, with
    the epilogue's contract written out; rounding is to ``a``'s dtype.

    Returns a tuple: (C,) for f32 / bf16 / bias_bf16 / bias_resid; (h, z)
    for bias_gelu (z rounded) and bias_gelu32 (z in f32); (dz rounded, the
    column sums of the f32 dz) for gelu_bwd / gelu32_bwd, whose ``z`` is the
    pre-activation (rounded, or f32)."""
    M, N, K = _gemm_dims(a, b, layout)
    if epi not in GEMM_EPIS[layout]:
        raise ValueError(f"layout {layout!r} takes the epilogues {GEMM_EPIS[layout]}, not {epi!r}")
    dt = a.dtype
    af, bf_ = a.float(), b.float()
    acc = af @ bf_.t() if layout == "nt" else (af @ bf_ if layout == "nn" else af.t() @ bf_)
    if epi == "f32":
        return (acc,)
    if epi == "bf16":
        return (acc.to(dt),)
    if epi in ("gelu_bwd", "gelu32_bwd"):
        dz = acc * _gelu_grad(z.float())
        return dz.to(dt), dz.sum(0)
    pre = acc + bias.float()
    if epi == "bias_bf16":
        return (pre.to(dt),)
    if epi == "bias_resid":  # bf16(R + bf16(acc + bias))
        return ((resid.float() + pre.to(dt).float()).to(dt),)
    if epi == "bias_gelu":  # z = bf16(acc + bias); h = bf16(gelu(z))
        zr = pre.to(dt)
        return F.gelu(zr.float()).to(dt), zr
    return F.gelu(pre).to(dt), pre  # bias_gelu32: z kept in f32


def gemm(a, b, layout: str, epi: str, bias=None, resid=None, z=None):
    """One product of the branch GEMM: on CUDA tensors the wgmma + TMA kernel
    of ``csrc/gemm_sm90.cuh`` for bf16 operands (through ``ssrl_gemm``,
    which also sums the weight gradient's split-K partials and the GELU
    backward's column sums), the SIMT kernel of ``csrc/gemm_f32_simt.cuh``
    for f32 ones (``gemm_f32``); ``gemm_ref`` on CPU tensors; the same
    outputs as ``gemm_ref``. The branch kernels run the same kernels from
    C++; this entry is for checking them alone."""
    if a.device.type == "cpu":
        return gemm_ref(a, b, layout, epi, bias, resid, z)
    M, N, K = _gemm_dims(a, b, layout)
    if epi not in GEMM_EPIS[layout]:
        raise ValueError(f"layout {layout!r} takes the epilogues {GEMM_EPIS[layout]}, not {epi!r}")
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return gemm_f32(a, b, layout, epi, bias, resid, z)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the GEMM takes bfloat16 or float32 operands (both alike), got "
                        f"{a.dtype}, {b.dtype}")
    if N % 8 or (layout != "tn" and K % 8) or (layout == "tn" and M % 8):
        raise ValueError(f"the GEMM takes N and the operands' row lengths in multiples of 8, "
                         f"got M={M} N={N} K={K} ({layout})")
    dev = a.device
    a, b = a.contiguous(), b.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    c = torch.empty((M, N), **f32) if epi == "f32" else torch.empty((M, N), dtype=a.dtype,
                                                                       device=dev)
    zout = zout32 = colsum = zin = zin32 = None
    if epi == "bias_gelu":
        zout = torch.empty((M, N), dtype=a.dtype, device=dev)
    elif epi == "bias_gelu32":
        zout32 = torch.empty((M, N), **f32)
    elif epi == "gelu_bwd":
        zin, colsum = z.to(a.dtype).contiguous(), torch.empty((N,), **f32)
    elif epi == "gelu32_bwd":
        zin32, colsum = z.float().contiguous(), torch.empty((N,), **f32)
    bias = bias.to(a.dtype).contiguous() if bias is not None else None
    resid = resid.to(a.dtype).contiguous() if resid is not None else None
    lib = _build.load()
    ws = _workspace(lib.ssrl_gemm_workspace(_LAYOUT_CODE[layout], M, N, K), a)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    LAUNCHES["gemm"] += 1
    _build.check(lib.ssrl_gemm(
        _LAYOUT_CODE[layout], _EPI_CODE[epi], a.data_ptr(), b.data_ptr(), c.data_ptr(),
        ptr(bias), ptr(resid), ptr(zin), ptr(zout), ptr(zin32), ptr(zout32), ptr(colsum),
        ws.data_ptr(), M, N, K, _stream(a),
    ), f"gemm {layout} {epi}")
    if epi == "bias_gelu":
        return c, zout
    if epi == "bias_gelu32":
        return c, zout32
    if colsum is not None:
        return c, colsum
    return (c,)


def gemm_f32(a, b, layout: str, epi: str, bias=None, resid=None, z=None):
    """``gemm`` on f32 CUDA operands (C entry ``ssrl_gemm_f32``): every
    epilogue of ``GEMM_EPIS`` read at f32, where its roundings are no-ops,
    so the outputs are ``gemm_ref``'s at f32: (C,); (h, z) for bias_gelu
    and bias_gelu32; (dz, its column sums) for gelu_bwd and gelu32_bwd.
    Any M, N, K >= 1."""
    M, N, K = _gemm_dims(a, b, layout)
    if min(M, N, K) < 1:
        raise ValueError(f"the f32 GEMM takes M, N, K >= 1, got M={M} N={N} K={K} ({layout})")
    dev = a.device
    a, b = a.contiguous(), b.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    c = torch.empty((M, N), **f32)
    zout = colsum = zin = None
    if epi in ("bias_gelu", "bias_gelu32"):
        zout = torch.empty((M, N), **f32)
    elif epi in ("gelu_bwd", "gelu32_bwd"):
        zin, colsum = z.float().contiguous(), torch.empty((N,), **f32)
    # only what the epilogue reads goes to the kernel
    bias = bias.float().contiguous() if epi.startswith("bias") else None
    resid = resid.float().contiguous() if epi == "bias_resid" else None
    lib = _build.load()
    ws = _workspace(lib.ssrl_gemm_f32_workspace(_LAYOUT_CODE[layout], M, N, K), a)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    LAUNCHES["gemm_f32"] += 1
    _build.check(lib.ssrl_gemm_f32(
        _LAYOUT_CODE[layout], _EPI_CODE[epi], a.data_ptr(), b.data_ptr(), c.data_ptr(),
        ptr(bias), ptr(resid), ptr(zin), ptr(zout), ptr(colsum), ws.data_ptr(), M, N, K,
        _stream(a),
    ), f"gemm_f32 {layout} {epi}")
    if zout is not None:
        return c, zout
    if colsum is not None:
        return c, colsum
    return (c,)


def _ln_bwd(dy, x, scale):
    """f32 LayerNorm backward from f32 dy: (dx, d scale, d bias)."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * inv
    g0 = dy * scale.float()
    dx = (g0 - g0.mean(-1, keepdim=True) - xhat * (g0 * xhat).mean(-1, keepdim=True)) * inv
    return dx, (_rows(dy) * _rows(xhat)).sum(0), _rows(dy).sum(0)


def mlp_bwd_plain(x, p, gy, round_z: bool):
    """(gy + the MLP branch's input gradient, in f32; its 6 f32 parameter
    gradients) from the f32 output gradient ``gy``, rounded only as the
    GEMM operand; d b2 sums the f32 gy (``block_pallas.py:288-298``,
    ``block_chain.py:147-166``)."""
    dt = x.dtype
    ln_scale, ln_bias, w1, b1, w2, _ = p
    y2 = layer_norm(x, ln_scale, ln_bias).to(dt)
    z = _dense(y2, w1, b1)
    if round_z:
        z = z.to(dt).float()
    h = F.gelu(z).to(dt)
    gc = gy.to(dt).float()
    dz = (gc @ w2.to(dt).float()) * _gelu_grad(z)
    dzc = dz.to(dt).float()
    dx, ds, db = _ln_bwd(dzc @ w1.to(dt).float(), x, ln_scale)
    return gy + dx, (ds, db, _tn(dzc, y2), _rows(dz).sum(0), _tn(gc, h), _rows(gy).sum(0))


def attn_bwd_plain(x, p, a, gy, num_heads):
    """The attention branch's counterpart of ``mlp_bwd_plain``, from the
    branch input ``x`` and attention output ``a``; dbqkv sums the f32 dqkv
    and dbp the f32 gy (``block_pallas.py:300-316``, ``block_chain.py:167-194``)."""
    dt = x.dtype
    ln_scale, ln_bias, wqkv, bqkv, wproj, _ = p
    B, L, D = x.shape
    y1 = layer_norm(x, ln_scale, ln_bias).to(dt)
    qkv = _dense(y1, wqkv, bqkv).to(dt)
    dp = gy.to(dt).float()
    da = (dp @ wproj.to(dt).float()).to(dt)
    q, k, v = (heads_of(t, num_heads) for t in qkv.chunk(3, dim=-1))
    parts = plain_bwd_f32(q, k, v, heads_of(da, num_heads), post=False)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, L, D) for t in parts], dim=-1)
    dqkvc = dqkv.to(dt).float()
    dx, ds, db = _ln_bwd(dqkvc @ wqkv.to(dt).float(), x, ln_scale)
    return gy + dx, (ds, db, _tn(dqkvc, y1), _rows(dqkv).sum(0), _tn(dp, a), _rows(gy).sum(0))


def block_bwd_plain(x, params, g, num_heads):
    """The whole block's backward from x, by full recompute: (dx rounded
    once, the 12 gradients cast to each parameter's dtype)."""
    x_mid, a = attn_fwd_plain(x, params[:6], num_heads)
    gy, gm = mlp_bwd_plain(x_mid, params[6:], g.to(x.dtype).float(), round_z=False)
    gy, ga = attn_bwd_plain(x, params[:6], a, gy, num_heads)
    return gy.to(x.dtype), [d.to(t.dtype) for d, t in zip(ga + gm, params)]


class _BlockPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_heads, *params):
        ctx.save_for_backward(x, *params)
        ctx.num_heads = num_heads
        x_mid, _ = attn_fwd_plain(x, params[:6], num_heads)
        return mlp_fwd_plain(x_mid, params[6:], round_z=False)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx, grads = block_bwd_plain(x, params, g, ctx.num_heads)
        return (dx, None, *grads)


def block_ref(x, params, num_heads):
    """Plain whole block: ``params`` the 12 tensors in ``_BLOCK_TREE`` order
    (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2),
    weights in torch Linear layout."""
    return _BlockPlain.apply(x, num_heads, *params)


def supported(B: int, L: int, D: int, H: int, F: int) -> bool:
    """Whether the block kernels (``fused_block`` and the chain) take the
    shape: ``ssrl::block_shape_ok`` of ``csrc/branch.cuh`` -- 8 <= D <= 256,
    D and F multiples of 8, D % H == 0, and the attention core's fit
    (head dim <= 32, ``attention_core.fits``). The JAX package's VMEM bound
    (``block_pallas.supported``) is a TPU fit, not this one."""
    return (B >= 1 and 8 <= D <= 256 and D % 8 == 0 and F >= 8 and F % 8 == 0
            and H >= 1 and D % H == 0 and fits(L, D // H))


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------


def _prep6(ln_s, ln_b, wa, ba, wb, bb, dt):
    """Kernel operands: f32 LN params, weights and biases in the compute
    dtype, contiguous (weights are cast per call, as ``_prep6`` does)."""
    f32 = [t.detach().float().contiguous() for t in (ln_s, ln_b)]
    return f32 + [t.detach().to(dt).contiguous() for t in (wa, ba, wb, bb)]


def _check_x(x: torch.Tensor, D: int) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernels take {' or '.join(map(str, _DTYPES))} activations, "
                        f"got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] != D:
        raise ValueError(f"expected (B, L, {D}) activations, got {tuple(x.shape)}")


def _check_params(params, shapes) -> None:
    for t, shape in zip(params, shapes):
        if t.device.type != "cuda" or tuple(t.shape) != shape:
            raise ValueError(
                f"block parameter must be a CUDA tensor of shape {shape}, "
                f"got {tuple(t.shape)} on {t.device}"
            )


def _scale(D: int, num_heads: int) -> float:
    return 1.0 / (D // num_heads) ** 0.5


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _workspace(nbytes: int, x: torch.Tensor) -> torch.Tensor:
    return torch.empty(int(nbytes), dtype=torch.uint8, device=x.device)


def dtype_key(dtype: torch.dtype, name: str) -> str:
    """``name`` at bf16, ``<name>_f32`` at f32: the f32 kernels' C entries
    and launch counters."""
    return name + ("_f32" if dtype == torch.float32 else "")


def _entry(x: torch.Tensor, name: str):
    """(the C entry ``ssrl_<name>`` of x's dtype, its workspace size, its
    ``LAUNCHES`` key): the f32 kernels take the bf16 entries' arguments
    under ``<name>_f32``."""
    key = dtype_key(x.dtype, name)
    lib = _build.load()
    return getattr(lib, f"ssrl_{key}"), getattr(lib, f"ssrl_{key}_workspace"), key


def _attn_fwd_cuda(x, kp, num_heads: int, stash: bool):
    B, L, D = x.shape
    lib = _build.load()
    if x.dtype == torch.float32 and not lib.ssrl_attn_f32_fits(L, D // num_heads, int(stash)):
        raise ValueError(f"the f32 attention core does not take L={L} d={D // num_heads}"
                         + (" with a backward" if stash else ""))
    fn, ws_fn, key = _entry(x, "attn_branch_fwd")
    out = torch.empty_like(x)
    a = torch.empty_like(x) if stash else None
    ws = _workspace(ws_fn(B, L, D, int(stash)), x)
    if not stash:  # the same kernel, counted apart: attn_branch_fwd_nograd[_f32]
        key = key.replace("_fwd", "_fwd_nograd")
    LAUNCHES[key] += 1
    _build.check(fn(
        x.data_ptr(), *(p.data_ptr() for p in kp), out.data_ptr(),
        a.data_ptr() if stash else None, ws.data_ptr(),
        B, L, D, num_heads, _scale(D, num_heads), _stream(x),
    ), key)
    return out, a


def _attn_bwd_cuda(x, kp, a, g, num_heads: int):
    B, L, D = x.shape
    fn, ws_fn, name = _entry(x, "attn_branch_bwd")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dln3 = torch.empty((3, D), **f32)
    dwqkv = torch.empty((3 * D, D), **f32)
    dbqkv = torch.empty((3 * D,), **f32)
    dwp = torch.empty((D, D), **f32)
    ws = _workspace(ws_fn(B, L, D), x)
    s, b, wqkv, bqkv, wp, _ = kp
    LAUNCHES[name] += 1
    _build.check(fn(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wp.data_ptr(), a.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dln3.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(),
        dwp.data_ptr(), ws.data_ptr(),
        B, L, D, num_heads, _scale(D, num_heads), _stream(x),
    ), name)
    # (d ln_s, d ln_b, d wqkv, d bqkv, d wp, d bp)
    return dx, (dln3[0], dln3[1], dwqkv, dbqkv, dwp, dln3[2])


def _mlp_fwd_cuda(x, kp):
    B, L, D = x.shape
    F_ = kp[2].shape[0]
    fn, ws_fn, name = _entry(x, "mlp_branch_fwd")
    out = torch.empty_like(x)
    ws = _workspace(ws_fn(B * L, D, F_), x)
    LAUNCHES[name] += 1
    _build.check(fn(
        x.data_ptr(), *(p.data_ptr() for p in kp), out.data_ptr(),
        ws.data_ptr(), B * L, D, F_, _stream(x),
    ), name)
    return out


def _mlp_bwd_cuda(x, kp, g):
    B, L, D = x.shape
    F_ = kp[2].shape[0]
    fn, ws_fn, name = _entry(x, "mlp_branch_bwd")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dln3 = torch.empty((3, D), **f32)
    dw1 = torch.empty((F_, D), **f32)
    db1 = torch.empty((F_,), **f32)
    dw2 = torch.empty((D, F_), **f32)
    ws = _workspace(ws_fn(B * L, D, F_), x)
    s, b, w1, b1, w2, _ = kp
    LAUNCHES[name] += 1
    _build.check(fn(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), dln3.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), ws.data_ptr(),
        B * L, D, F_, _stream(x),
    ), name)
    # (d ln_s, d ln_b, d w1, d b1, d w2, d b2)
    return dx, (dln3[0], dln3[1], dw1, db1, dw2, dln3[2])


def prep12(params, dt):
    """A block's kernel operands, ``_prep6`` of each branch."""
    return _prep6(*params[:6], dt) + _prep6(*params[6:], dt)


def block_shapes(D: int, F_: int):
    """The 12 parameter shapes of a block, torch layout."""
    return [(D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,),
            (D,), (D,), (F_, D), (F_,), (D, F_), (D,)]


def pointers(ts) -> ctypes.Array:
    """A C array of the tensors' device addresses."""
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def block_grad_floats(D: int, F_: int) -> int:
    return 3 * D + 3 * D * D + 3 * D + D * D + 3 * D + F_ * D + F_ + D * F_


def grad_views(buf: torch.Tensor, D: int, F_: int):
    """One block's 12 gradients, in parameter order, as views of its packed
    f32 buffer (the layout of ``ssrl::block_grads`` in ``csrc/branch.cuh``)."""
    dln_a, dwqkv, dbqkv, dwp, dln_m, dw1, db1, dw2 = buf.split(
        [3 * D, 3 * D * D, 3 * D, D * D, 3 * D, F_ * D, F_, D * F_])
    return (dln_a[:D], dln_a[D:2 * D], dwqkv.view(3 * D, D), dbqkv, dwp.view(D, D),
            dln_a[2 * D:], dln_m[:D], dln_m[D:2 * D], dw1.view(F_, D), db1,
            dw2.view(D, F_), dln_m[2 * D:])


def check_block(x, params, num_heads: int, bwd: bool) -> int:
    """Raise on what the block kernels do not take (at f32 also a shape the
    f32 attention core does not fit, its backward's with ``bwd``); return F."""
    B, L, D = x.shape if x.dim() == 3 else (0, 0, -1)
    _check_x(x, D)
    F_ = params[8].shape[0]
    if not supported(B, L, D, num_heads, F_):
        raise ValueError(f"the block kernels do not take B={B} L={L} D={D} "
                         f"H={num_heads} F={F_}")
    if x.dtype == torch.float32 and not _build.load().ssrl_attn_f32_fits(
            L, D // num_heads, int(bwd)):
        raise ValueError(f"the f32 block kernels do not take L={L} d={D // num_heads}"
                         + (" with a backward" if bwd else ""))
    _check_params(params, block_shapes(D, F_))
    return F_


def _block_fwd_cuda(x, kp, num_heads: int, grad: bool):
    B, L, D = x.shape
    F_ = kp[8].shape[0]
    fn, ws_fn, _ = _entry(x, "fused_block_fwd")
    out = torch.empty_like(x)
    ws = _workspace(ws_fn(B, L, D, F_), x)
    key = dtype_key(x.dtype, "block_fwd" if grad else "block_fwd_nograd")
    LAUNCHES[key] += 1
    count_mlp_half(x.dtype, "fwd", 1)
    _build.check(fn(
        x.data_ptr(), pointers(kp), out.data_ptr(), ws.data_ptr(),
        B, L, D, num_heads, F_, _scale(D, num_heads), _stream(x),
    ), key)
    return out


def _block_bwd_cuda(x, kp, g, num_heads: int):
    B, L, D = x.shape
    F_ = kp[8].shape[0]
    fn, ws_fn, _ = _entry(x, "fused_block_bwd")
    dx = torch.empty_like(x)
    grads = torch.empty(block_grad_floats(D, F_), dtype=torch.float32, device=x.device)
    ws = _workspace(ws_fn(B, L, D, F_), x)
    key = dtype_key(x.dtype, "block_bwd")
    LAUNCHES[key] += 1
    count_mlp_half(x.dtype, "bwd", 1)
    _build.check(fn(
        x.data_ptr(), pointers(kp), g.data_ptr(), dx.data_ptr(), grads.data_ptr(),
        ws.data_ptr(), B, L, D, num_heads, F_, _scale(D, num_heads), _stream(x),
    ), key)
    return dx, grad_views(grads, D, F_)


def count_mlp_half(dtype: torch.dtype, pas: str, blocks: int) -> None:
    """Count the MLP-half kernel launches of a bf16 whole block or chain of
    ``blocks`` blocks (``pas``: "fwd" or "bwd"); the f32 entries run the
    split sequences of ``csrc/branch_f32.cuh`` instead."""
    if dtype == torch.bfloat16:
        LAUNCHES[f"mlp_half_{pas}"] += blocks


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_heads, *params):
        kp = prep12(params, x.dtype)
        ctx.save_for_backward(x, *kp)
        ctx.num_heads = num_heads
        ctx.param_dtypes = [t.dtype for t in params]
        return _block_fwd_cuda(x, kp, num_heads, grad=True)

    @staticmethod
    def backward(ctx, g):
        x, *kp = ctx.saved_tensors
        dx, dparams = _block_bwd_cuda(x, kp, g.to(x.dtype).contiguous(), ctx.num_heads)
        return (dx, None, *(d.to(t) for d, t in zip(dparams, ctx.param_dtypes)))


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


# ---------------------------------------------------------------------------
# The branches split over a model axis: partial, all-reduce, finish
# ---------------------------------------------------------------------------


def tp_scale(wqkv, num_heads: int) -> float:
    """The softmax scale of a shard, from its own head dim: ``wqkv`` holds
    3·Da rows for ``num_heads`` local heads. ``_scale`` divides D by H; a
    shard's Da = (H/mp)·d over its H/mp heads gives the same d, so the
    same scale."""
    return 1.0 / (wqkv.shape[0] // 3 // num_heads) ** 0.5


def _attn_part_from_y(y1, wqkv, bqkv, wproj, num_heads):
    """A shard's attention after LN1: (a Wp^T in f32, no bias; a)."""
    dt = y1.dtype
    B, L, _ = y1.shape
    Da = wqkv.shape[0] // 3
    d = Da // num_heads
    qkv = _dense(y1, wqkv, bqkv).to(dt)
    q, k, v = qkv.reshape(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q = (q.float() * tp_scale(wqkv, num_heads)).to(dt)
    a = mha_xla(q, k, v, scale=1.0).transpose(1, 2).reshape(B, L, Da)
    return a.float() @ wproj.to(dt).float().t(), a


def _mlp_part_from_y(y2, w1, b1, w2):
    """A shard's MLP after LN2: h W2^T in f32, no bias."""
    dt = y2.dtype
    h = F.gelu(_dense(y2, w1, b1).to(dt).float()).to(dt)
    return h.float() @ w2.to(dt).float().t()


def attn_part_plain(x, p, num_heads):
    """The partial forward of a shard ``p`` = (ln_s, ln_b, wqkv (3Da, D),
    bqkv (3Da,), wproj (D, Da)): (the f32 sum a Wp^T, the attention output
    ``a`` (B, L, Da))."""
    ln_scale, ln_bias, wqkv, bqkv, wproj = p
    return _attn_part_from_y(layer_norm(x, ln_scale, ln_bias).to(x.dtype), wqkv, bqkv, wproj,
                             num_heads)


def mlp_part_plain(x, p):
    """The partial forward of a shard ``p`` = (ln_s, ln_b, w1 (Fs, D), b1,
    w2 (D, Fs)): the f32 sum h W2^T."""
    ln_scale, ln_bias, w1, b1, w2 = p
    return _mlp_part_from_y(layer_norm(x, ln_scale, ln_bias).to(x.dtype), w1, b1, w2)


def branch_finish_plain(x, s, b):
    """x + round(s + b) from the all-reduced f32 sum ``s``: the bias-residual
    epilogue's rounding points."""
    dt = x.dtype
    return x + (s.float() + b.to(dt).float()).to(dt)


def attn_part_bwd_plain(x, p, a, gy, num_heads):
    """A shard's partial backward, ``attn_bwd_plain``'s rounding points:
    (the f32 part dqkv Wqkv of LN1's output gradient, (dwqkv, dbqkv, dwp))."""
    dt = x.dtype
    ln_scale, ln_bias, wqkv, bqkv, wproj = p
    B, L, _ = x.shape
    Da = wqkv.shape[0] // 3
    y1 = layer_norm(x, ln_scale, ln_bias).to(dt)
    qkv = _dense(y1, wqkv, bqkv).to(dt)
    dp = gy.to(dt).float()
    da = (dp @ wproj.to(dt).float()).to(dt)
    q, k, v = (heads_of(t, num_heads) for t in qkv.chunk(3, dim=-1))
    parts = plain_bwd_f32(q, k, v, heads_of(da, num_heads), post=False)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, L, Da) for t in parts], dim=-1)
    dqkvc = dqkv.to(dt).float()
    return dqkvc @ wqkv.to(dt).float(), (_tn(dqkvc, y1), _rows(dqkv).sum(0), _tn(dp, a))


def mlp_part_bwd_plain(x, p, gy):
    """A shard's partial backward, ``mlp_bwd_plain``'s rounding points (z
    rounded): (the f32 part dz W1 of LN2's output gradient, (dw1, db1, dw2))."""
    dt = x.dtype
    ln_scale, ln_bias, w1, b1, w2 = p
    y2 = layer_norm(x, ln_scale, ln_bias).to(dt)
    z = _dense(y2, w1, b1).to(dt).float()
    h = F.gelu(z).to(dt)
    gc = gy.to(dt).float()
    dz = (gc @ w2.to(dt).float()) * _gelu_grad(z)
    dzc = dz.to(dt).float()
    return dzc @ w1.to(dt).float(), (_tn(dzc, y2), _rows(dz).sum(0), _tn(gc, h))


def ln_bwd_plain(x, ln_scale, dy, gy):
    """(dx = gy + LN'(dy) in x's dtype, (d ln_s, d ln_b, sum gy)) from the
    all-reduced f32 ``dy`` and the branch output gradient ``gy`` as x's
    dtype holds it."""
    dx, _, sums = ln_bwd_full_plain(x, ln_scale, dy, gy.to(x.dtype))
    return dx, sums


def ln_bwd_full_plain(x, ln_scale, dy, gy):
    """The LN backward of every branch, block and chain backward: (dx in x's
    dtype, dx in f32 before that rounding, (d ln_s, d ln_b, sum gy)). An f32
    ``gy`` with a bf16 ``x`` (the whole block's and chain's gradient) enters
    the residual and the sum as it is, any other as x's dtype holds it."""
    dx, ds, db = _ln_bwd(dy.float(), x, ln_scale)
    g = gy.float() if gy.dtype == torch.float32 else gy.to(x.dtype).float()
    r = g + dx
    return r.to(x.dtype), r, (ds, db, _rows(g).sum(0))


#: the LN backward kernel's plan (csrc/common.cuh::ln_bwd_plan): threads a
#: block, rows a thread takes a step, most blocks, blocks a group fold
LNB_THREADS, LNB_U, LNB_MAX_BLOCKS, LNB_GROUP = 256, 2, 264, 16


def ln_bwd_plan(M: int, D: int) -> dict:
    """csrc/common.cuh::ln_bwd_plan: G threads a row, RB rows side by side in
    a block, rpb rows a block, the grid, the groups whose partials the last
    block of each folds."""
    G = (D + 7) // 8
    RB = LNB_THREADS // G
    steps = -(-M // (RB * LNB_U))
    nb = max(1, min(steps, LNB_MAX_BLOCKS))
    rpb = -(-M // nb) if M > nb else 1
    blocks = -(-M // rpb)
    return {"G": G, "RB": RB, "rpb": rpb, "blocks": blocks, "groups": -(-blocks // LNB_GROUP)}


def ln_colsum_blocked(v):
    """Column sums of ``v`` [M, D] in the LN backward kernel's order: each
    thread's rows ri, ri + RB, ... of its block's range one after another,
    the block's RB row slots in order, the blocks of a group in order, the
    groups in order."""
    M, D = v.shape
    p = ln_bwd_plan(M, D)
    RB, rpb = p["RB"], p["rpb"]
    parts = []
    for b in range(p["blocks"]):
        rows = v[b * rpb:min(M, (b + 1) * rpb)]
        pad = -rows.shape[0] % RB
        slots = torch.cat([rows, rows.new_zeros(pad, D)]).view(-1, RB, D)
        acc = torch.zeros(RB, D, dtype=v.dtype)
        for step in slots:  # a thread's rows in order
            acc = acc + step
        t = torch.zeros(D, dtype=v.dtype)
        for r in range(RB):  # the block's row slots in order
            t = t + acc[r]
        parts.append(t)
    groups = []
    for g in range(p["groups"]):
        t = torch.zeros(D, dtype=v.dtype)
        for b in parts[g * LNB_GROUP:(g + 1) * LNB_GROUP]:
            t = t + b
        groups.append(t)
    out = torch.zeros(D, dtype=v.dtype)
    for t in groups:
        out = out + t
    return out if p["groups"] > 1 else groups[0]


def _model_sum(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` (a fresh buffer) summed over the model group in place."""
    if axis is not None and axis.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


def attn_branch_tp_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, axis):
    """Plain attention branch of a shard over the model ``axis``: LN1,
    ``copy_to_model``, the shard's heads, ``reduce_from_model`` of proj's
    f32 sum, then bias and residual. Autograd's backward all-reduces LN1's
    output gradient, so the LN and bias gradients are the full ones."""
    y1 = copy_to_model(layer_norm(x, ln_scale, ln_bias).to(x.dtype), axis)
    part, _ = _attn_part_from_y(y1, wqkv, bqkv, wproj, num_heads)
    return branch_finish_plain(x, reduce_from_model(part, axis), bproj)


def mlp_branch_tp_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, axis):
    """Plain MLP branch of a shard over the model ``axis`` (see
    ``attn_branch_tp_ref``)."""
    y2 = copy_to_model(layer_norm(x, ln_scale, ln_bias).to(x.dtype), axis)
    part = _mlp_part_from_y(y2, w1, b1, w2)
    return branch_finish_plain(x, reduce_from_model(part, axis), b2)


def _attn_part_fwd_cuda(x, kp, num_heads: int, stash: bool):
    B, L, D = x.shape
    Da = kp[2].shape[0] // 3
    if x.dtype == torch.float32 and not _build.load().ssrl_attn_f32_fits(
            L, Da // num_heads, int(stash)):
        raise ValueError(f"the f32 attention core does not take L={L} d={Da // num_heads}"
                         + (" with a backward" if stash else ""))
    fn, ws_fn, key = _entry(x, "attn_branch_part_fwd")
    part = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    a = torch.empty((B, L, Da), dtype=x.dtype, device=x.device) if stash else None
    ws = _workspace(ws_fn(B, L, D, Da, int(stash)), x)
    if not stash:
        key = key.replace("_fwd", "_fwd_nograd")
    LAUNCHES[key] += 1
    _build.check(fn(
        x.data_ptr(), *(t.data_ptr() for t in kp[:5]), part.data_ptr(),
        a.data_ptr() if stash else None, ws.data_ptr(),
        B, L, D, Da, num_heads, tp_scale(kp[2], num_heads), _stream(x),
    ), key)
    return part, a


def _attn_part_bwd_cuda(x, kp, a, g, num_heads: int):
    B, L, D = x.shape
    Da = kp[2].shape[0] // 3
    fn, ws_fn, key = _entry(x, "attn_branch_part_bwd")
    f32 = dict(dtype=torch.float32, device=x.device)
    dy1 = torch.empty((B, L, D), **f32)
    dwqkv = torch.empty((3 * Da, D), **f32)
    dbqkv = torch.empty((3 * Da,), **f32)
    dwp = torch.empty((D, Da), **f32)
    ws = _workspace(ws_fn(B, L, D, Da), x)
    LAUNCHES[key] += 1
    _build.check(fn(
        x.data_ptr(), *(t.data_ptr() for t in kp[:5]), a.data_ptr(), g.data_ptr(),
        dy1.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(), dwp.data_ptr(), ws.data_ptr(),
        B, L, D, Da, num_heads, tp_scale(kp[2], num_heads), _stream(x),
    ), key)
    return dy1, (dwqkv, dbqkv, dwp)


def _mlp_part_fwd_cuda(x, kp):
    B, L, D = x.shape
    F_ = kp[2].shape[0]
    fn, ws_fn, key = _entry(x, "mlp_branch_part_fwd")
    part = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    ws = _workspace(ws_fn(B * L, D, F_), x)
    LAUNCHES[key] += 1
    _build.check(fn(
        x.data_ptr(), *(t.data_ptr() for t in kp[:5]), part.data_ptr(), ws.data_ptr(),
        B * L, D, F_, _stream(x),
    ), key)
    return part


def _mlp_part_bwd_cuda(x, kp, g):
    B, L, D = x.shape
    F_ = kp[2].shape[0]
    fn, ws_fn, key = _entry(x, "mlp_branch_part_bwd")
    f32 = dict(dtype=torch.float32, device=x.device)
    dy2 = torch.empty((B, L, D), **f32)
    dw1 = torch.empty((F_, D), **f32)
    db1 = torch.empty((F_,), **f32)
    dw2 = torch.empty((D, F_), **f32)
    ws = _workspace(ws_fn(B * L, D, F_), x)
    LAUNCHES[key] += 1
    _build.check(fn(
        x.data_ptr(), *(t.data_ptr() for t in kp[:5]), g.data_ptr(), dy2.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), ws.data_ptr(),
        B * L, D, F_, _stream(x),
    ), key)
    return dy2, (dw1, db1, dw2)


def _finish_cuda(x, s, b):
    D = x.shape[-1]
    key = dtype_key(x.dtype, "branch_finish")
    out = torch.empty_like(x)
    LAUNCHES[key] += 1
    _build.check(getattr(_build.load(), f"ssrl_{key}")(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel() // D, D,
        _stream(x),
    ), key)
    return out


def _ln_bwd_cuda(x, ln_s, dy, g):
    D = x.shape[-1]
    M = x.numel() // D
    fn, ws_fn, key = _entry(x, "branch_ln_bwd")
    dx = torch.empty_like(x)
    dln3 = torch.empty((3, D), dtype=torch.float32, device=x.device)
    ws = _workspace(ws_fn(M, D), x)
    LAUNCHES[key] += 1
    _build.check(fn(
        x.data_ptr(), ln_s.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dln3.data_ptr(), ws.data_ptr(), M, D, _stream(x),
    ), key)
    return dx, (dln3[0], dln3[1], dln3[2])


def _check_tp(x, params, shapes) -> None:
    _check_x(x, x.shape[-1] if x.dim() == 3 else -1)
    _check_params(params, shapes)


def attn_tp_shapes(D: int, Da: int):
    """A shard's six attention-branch shapes: LN at D, qkv rows and proj
    columns at Da, proj bias at D."""
    return [(D,), (D,), (3 * Da, D), (3 * Da,), (D, Da), (D,)]


def mlp_tp_shapes(D: int, Fs: int):
    return [(D,), (D,), (Fs, D), (Fs,), (D, Fs), (D,)]


class _AttnBranchTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wp, bp, num_heads, axis):
        kp = _prep6(ln_s, ln_b, wqkv, bqkv, wp, bp, x.dtype)
        part, a = _attn_part_fwd_cuda(x, kp, num_heads, stash=True)
        out = _finish_cuda(x, _model_sum(part, axis), kp[5])
        ctx.save_for_backward(x, a, *kp)
        ctx.num_heads, ctx.axis = num_heads, axis
        ctx.param_dtypes = [t.dtype for t in (ln_s, ln_b, wqkv, bqkv, wp, bp)]
        return out

    @staticmethod
    def backward(ctx, g):
        x, a, *kp = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dy1, (dwqkv, dbqkv, dwp) = _attn_part_bwd_cuda(x, kp, a, g, ctx.num_heads)
        dx, (ds, db, dbp) = _ln_bwd_cuda(x, kp[0], _model_sum(dy1, ctx.axis), g)
        grads = (ds, db, dwqkv, dbqkv, dwp, dbp)
        return (dx, *(d.to(t) for d, t in zip(grads, ctx.param_dtypes)), None, None)


class _MlpBranchTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w1, b1, w2, b2, axis):
        kp = _prep6(ln_s, ln_b, w1, b1, w2, b2, x.dtype)
        out = _finish_cuda(x, _model_sum(_mlp_part_fwd_cuda(x, kp), axis), kp[5])
        ctx.save_for_backward(x, *kp)
        ctx.axis = axis
        ctx.param_dtypes = [t.dtype for t in (ln_s, ln_b, w1, b1, w2, b2)]
        return out

    @staticmethod
    def backward(ctx, g):
        x, *kp = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dy2, (dw1, db1, dw2) = _mlp_part_bwd_cuda(x, kp, g)
        dx, (ds, db, db2) = _ln_bwd_cuda(x, kp[0], _model_sum(dy2, ctx.axis), g)
        grads = (ds, db, dw1, db1, dw2, db2)
        return (dx, *(d.to(t) for d, t in zip(grads, ctx.param_dtypes)), None)


def fused_attn_branch_tp(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, axis):
    """The attention branch of a shard over the model ``axis`` (a
    ``parallel.mesh.ModelAxis``; None: no all-reduce): ``wqkv`` (3Da, D)
    and ``bqkv`` hold the q, k and v rows of the shard's ``num_heads``
    heads, ``wproj`` (D, Da) their columns of proj; the LN parameters and
    ``bproj`` are the full ones. On CUDA the partial kernel, the all-reduce
    of its f32 sum and the finish kernel (``csrc/attn_branch.cu``, at f32
    ``csrc/branch_f32.cu``); ``attn_branch_tp_ref`` on the CPU."""
    params = (ln_scale, ln_bias, wqkv, bqkv, wproj, bproj)
    if _route(x) == "cpu":
        return attn_branch_tp_ref(x, *params, num_heads, axis)
    D, Da = x.shape[-1], wqkv.shape[0] // 3
    if Da % num_heads:
        raise ValueError(f"Da={Da} is not a multiple of num_heads={num_heads}")
    _check_tp(x, params, attn_tp_shapes(D, Da))
    x = x.contiguous()
    if _needs_grad(x, params):
        return _AttnBranchTP.apply(x, *params, num_heads, axis)
    kp = _prep6(*params, x.dtype)
    part, _ = _attn_part_fwd_cuda(x, kp, num_heads, stash=False)
    return _finish_cuda(x, _model_sum(part, axis), kp[5])


def fused_mlp_branch_tp(x, ln_scale, ln_bias, w1, b1, w2, b2, axis):
    """The MLP branch of a shard over the model ``axis``: ``w1`` (Fs, D),
    ``b1`` and ``w2`` (D, Fs) its slice of the hidden units, the LN
    parameters and ``b2`` full (see ``fused_attn_branch_tp``)."""
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    if _route(x) == "cpu":
        return mlp_branch_tp_ref(x, *params, axis)
    _check_tp(x, params, mlp_tp_shapes(x.shape[-1], w1.shape[0]))
    x = x.contiguous()
    if _needs_grad(x, params):
        return _MlpBranchTP.apply(x, *params, axis)
    kp = _prep6(*params, x.dtype)
    return _finish_cuda(x, _model_sum(_mlp_part_fwd_cuda(x, kp), axis), kp[5])


# The TP kernels one at a time (chip_smoke.py and the card's tests hold each
# to its plain version): a CUDA tensor launches the kernel, a CPU one runs
# the plain version.


def _prep_part(p, dt):
    """A partial kernel's five operands (``_prep6`` without the output bias)."""
    return ([t.detach().float().contiguous() for t in p[:2]]
            + [t.detach().to(dt).contiguous() for t in p[2:]])


def attn_branch_partial(x, p, num_heads, stash: bool = True):
    """(f32 sum, a or None) of a shard ``p`` = (ln_s, ln_b, wqkv, bqkv, wproj)."""
    if _route(x) == "cpu":
        part, a = attn_part_plain(x, p, num_heads)
        return part, a if stash else None
    return _attn_part_fwd_cuda(x.contiguous(), _prep_part(p, x.dtype), num_heads, stash)


def attn_branch_partial_bwd(x, p, a, gy, num_heads):
    if _route(x) == "cpu":
        return attn_part_bwd_plain(x, p, a, gy, num_heads)
    return _attn_part_bwd_cuda(x.contiguous(), _prep_part(p, x.dtype), a.contiguous(),
                               gy.to(x.dtype).contiguous(), num_heads)


def mlp_branch_partial(x, p):
    if _route(x) == "cpu":
        return mlp_part_plain(x, p)
    return _mlp_part_fwd_cuda(x.contiguous(), _prep_part(p, x.dtype))


def mlp_branch_partial_bwd(x, p, gy):
    if _route(x) == "cpu":
        return mlp_part_bwd_plain(x, p, gy)
    return _mlp_part_bwd_cuda(x.contiguous(), _prep_part(p, x.dtype),
                              gy.to(x.dtype).contiguous())


def branch_finish(x, s, b):
    if _route(x) == "cpu":
        return branch_finish_plain(x, s, b)
    return _finish_cuda(x.contiguous(), s.float().contiguous(), b.to(x.dtype).contiguous())


def branch_ln_bwd(x, ln_scale, dy, gy):
    if _route(x) == "cpu":
        return ln_bwd_plain(x, ln_scale, dy, gy)
    return _ln_bwd_cuda(x.contiguous(), ln_scale.float().contiguous(), dy.float().contiguous(),
                        gy.to(x.dtype).contiguous())


def ln_bwd(x, ln_scale, dy, gy, dx32: bool = False):
    """The LN backward's four bf16 instantiations alone: (dx, dx in f32 or
    None, (d ln_s, d ln_b, sum gy)); an f32 ``gy`` is taken as it is (the
    f32 gradient of the whole block and the chain), any other as bf16.
    A CUDA tensor launches the kernel (bf16 only), a CPU one runs
    ``ln_bwd_full_plain``."""
    if _route(x) == "cpu":
        dx, d32, sums = ln_bwd_full_plain(x, ln_scale, dy, gy)
        return dx, d32 if dx32 else None, sums
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ln_bwd takes bf16 activations on the card, not {x.dtype}")
    x = x.contiguous()
    D = x.shape[-1]
    M = x.numel() // D
    g32 = gy.float().contiguous() if gy.dtype == torch.float32 else None
    gb = None if g32 is not None else gy.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    d32 = torch.empty(x.shape, dtype=torch.float32, device=x.device) if dx32 else None
    dln3 = torch.empty((3, D), dtype=torch.float32, device=x.device)
    lib = _build.load()
    ws = _workspace(lib.ssrl_branch_ln_bwd_workspace(M, D), x)
    LAUNCHES["ln_bwd"] += 1
    _build.check(lib.ssrl_ln_bwd(
        x.data_ptr(), ln_scale.float().contiguous().data_ptr(), dy.float().contiguous().data_ptr(),
        gb.data_ptr() if gb is not None else None, g32.data_ptr() if g32 is not None else None,
        dx.data_ptr(), d32.data_ptr() if d32 is not None else None, dln3.data_ptr(),
        ws.data_ptr(), M, D, _stream(x),
    ), "ln_bwd")
    return dx, d32, (dln3[0], dln3[1], dln3[2])




# The MLP half of the bf16 whole block and chain alone (``csrc/block_mlp.cu``),
# and at f32 ``csrc/block_mlp_f32.cu``, which no block or chain runs
# (chip_smoke.py and the card's tests hold both to ``mlp_fwd_plain`` /
# ``mlp_bwd_plain``): a CUDA tensor launches the kernel, a CPU one runs the
# plain version.


def mlp_half_supported(D: int, F_: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the MLP-half kernels take (D, F) at ``dtype``: bf16
    ``ssrl::mlp_shape_ok`` -- 8 <= D <= 256, D and F multiples of 8; f32
    ``ssrl::mlp_f32_ok`` -- 1 <= D <= 256, any F >= 1 (any number of rows)."""
    if dtype == torch.float32:
        return 1 <= D <= 256 and F_ >= 1
    return 8 <= D <= 256 and D % 8 == 0 and F_ >= 8 and F_ % 8 == 0


def check_mlp_half(x, params) -> int:
    """Raise on what the MLP-half kernels do not take: bf16 or f32 (B, L,
    D) activations and the MLP's six parameters (ln_s, ln_b, w1 (F, D), b1,
    w2 (D, F), b2) at a (D, F) of ``mlp_half_supported``; return F."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the MLP-half kernels take {' or '.join(map(str, _DTYPES))} "
                        f"activations, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"expected (B, L, D) activations, got {tuple(x.shape)}")
    D, F_ = x.shape[-1], params[2].shape[0]
    if not mlp_half_supported(D, F_, x.dtype):
        raise ValueError(f"the MLP-half kernels do not take D={D} F={F_} at {x.dtype}")
    shapes = [(D,), (D,), (F_, D), (F_,), (D, F_), (D,)]
    for t, shape in zip(params, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"MLP parameter of shape {tuple(t.shape)}, expected {shape}")
    return F_


def mlp_half(x, p, round_z: bool = True):
    """The MLP half ``x + bf16(h W2^T + b2)`` of ``p`` = (ln_s, ln_b, w1, b1,
    w2, b2), z rounded to bf16 (``round_z``, the chain) or kept in f32 (the
    whole block); at f32 every rounding is a no-op and ``round_z`` changes
    nothing: ``mlp_fwd_plain`` on the CPU, the kernel on the card."""
    if _route(x) == "cpu":
        return mlp_fwd_plain(x, p, round_z)
    F_ = check_mlp_half(x, p)
    _check_params(p, [tuple(t.shape) for t in p])  # on the card
    x = x.contiguous()
    kp = _prep6(*p, x.dtype)
    B, L, D = x.shape
    out = torch.empty_like(x)
    key = dtype_key(x.dtype, "mlp_half_fwd")
    lib = _build.load()
    args = (x.data_ptr(), *(t.data_ptr() for t in kp), out.data_ptr(), B * L, D, F_)
    LAUNCHES[key] += 1
    if x.dtype == torch.float32:
        code = lib.ssrl_mlp_half_fwd_f32(*args, _stream(x))
    else:
        code = lib.ssrl_mlp_half_fwd(*args, int(round_z), _stream(x))
    _build.check(code, key)
    return out


def mlp_half_bwd(x, p, gy, round_z: bool = True):
    """The MLP half's backward from the f32 gradient ``gy`` at its output:
    (gy + its input gradient in f32, the six f32 parameter gradients), as
    ``mlp_bwd_plain`` returns them; the kernel on the card (at bf16 it also
    writes the bf16 form of the first, which the whole block and the chain
    pass on), ``mlp_bwd_plain`` on the CPU."""
    if _route(x) == "cpu":
        return mlp_bwd_plain(x, p, gy.float(), round_z)
    F_ = check_mlp_half(x, p)
    _check_params(p, [tuple(t.shape) for t in p])  # on the card
    x = x.contiguous()
    s, b, w1, b1, w2, _ = _prep6(*p, x.dtype)
    B, L, D = x.shape
    g32 = gy.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx32 = torch.empty_like(g32)
    dln3 = torch.empty((3, D), **f32)
    dw1, db1, dw2 = (torch.empty(shape, **f32) for shape in ((F_, D), (F_,), (D, F_)))
    lib = _build.load()
    if x.dtype == torch.float32:
        ws = _workspace(lib.ssrl_mlp_half_bwd_f32_workspace(B * L, D, F_), x)
        LAUNCHES["mlp_half_bwd_f32"] += 1
        _build.check(lib.ssrl_mlp_half_bwd_f32(
            x.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), g32.data_ptr(), dx32.data_ptr(), dln3.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), ws.data_ptr(), B * L, D, F_, _stream(x),
        ), "mlp_half_bwd_f32")
        return dx32, (dln3[0], dln3[1], dw1, db1, dw2, dln3[2])
    gbf = g32.to(x.dtype)
    dx = torch.empty_like(x)
    ws = _workspace(lib.ssrl_mlp_half_bwd_workspace(B * L, D, F_), x)
    LAUNCHES["mlp_half_bwd"] += 1
    _build.check(lib.ssrl_mlp_half_bwd(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), gbf.data_ptr(), g32.data_ptr(), dx.data_ptr(), dx32.data_ptr(),
        dln3.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), ws.data_ptr(),
        B * L, D, F_, int(round_z), _stream(x),
    ), "mlp_half_bwd")
    return dx32, (dln3[0], dln3[1], dw1, db1, dw2, dln3[2])


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
    no-grad primal of ``block_pallas._fused_attn_branch``); f32 activations
    take the f32 kernels of ``csrc/branch_f32.cu``."""
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
    """x + fc2(GELU(fc1(LN2(x)))): kernels on CUDA, plain on CPU; f32
    activations take the f32 kernels."""
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


def fused_block(x, params, num_heads):
    """The whole pre-LN block (``block_pallas.fused_block``): the kernels of
    ``csrc/fused_block.cu`` (bf16) or ``csrc/fused_block_f32.cu`` (f32) on
    CUDA, ``block_ref`` on CPU. ``params``: the 12 tensors in
    ``_BLOCK_TREE`` order, weights in torch Linear layout."""
    params = tuple(params)
    if _route(x) == "cpu":
        return block_ref(x, params, num_heads)
    grad = _needs_grad(x, params)
    check_block(x, params, num_heads, grad)
    x = x.contiguous()
    if grad:
        return _Block.apply(x, num_heads, *params)
    return _block_fwd_cuda(x, prep12(params, x.dtype), num_heads, grad=False)
