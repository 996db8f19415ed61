"""Multi-head attention: one CUDA kernel, three layouts, two scale contracts.

The four attention entries of the port (``attention_stacked.py``,
``attention_heads.py``, ``attention_packed.py``) compute one function,
softmax(q kᵀ/√d) v over heads, each on its own layout. An :class:`Entry`
says how the entry's tensors map onto the (B, H, L, d) problem; the kernel of
``csrc/mha.cu`` reads and writes them in place through strides, so no layout
copy is made on the card.

Two rounding contracts (``csrc/mha.cuh``):

- pre-scaled (``attention_pallas_stacked.py:176``, ``attention_pallas_packed.py:89``):
  q scaled in f32 and rounded to the input dtype before QKᵀ;
  dq = (dS K)·scale, dk = dSᵀ q_scaled;
- post-scaled (``attention_pallas.py:87-90,117-128``): the f32 scores are
  scaled after QKᵀ; dq = (dS K)·scale, dk = (dSᵀ q)·scale.

Both round P and dS to the input dtype before their second product, keep
scores, softmax and accumulation in f32, and round each output once.

:func:`attend` routes by device: a CPU tensor takes the plain version, a
``torch.autograd.Function`` whose forward and backward repeat the kernel's
arithmetic in tensor ops (autograd over a bf16 forward would round
elsewhere); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ssrl_vit_mae_jepa_torch import _build

#: kernel launches by wrapper entry; a wrapper adds one where it launches
LAUNCHES = {
    f"{name}_{pas}": 0
    for name in ("mha_stacked_qkv", "mha_stacked", "mha_pallas", "mha_packed")
    for pas in ("fwd", "bwd")
}

SMEM_MAX = 232448  # dynamic shared memory a block may use on sm_90
_ATT_WARPS, _BWD_WARPS, _TLD = 4, 5, 20


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(L: int, d: int) -> bool:
    """Whether the kernel takes (L, d): ``ssrl::mha_fits`` of ``csrc/mha.cu``,
    the head dim at most 32 and the backward's shared memory (bf16 q, k, v,
    dO and the whole head's P and dS, plus one f32 strip per warp)."""
    if L < 1 or not 1 <= d <= 32:
        return False
    LP, DP = -(-L // 16) * 16, -(-d // 16) * 16
    per_warp = 16 * (LP + 4) * 4 + 16 * _TLD * 4 + 3 * DP * 4
    smem = 4 * LP * (DP + 8) * 2 + 2 * LP * (LP + 8) * 2 + _BWD_WARPS * per_warp
    return smem <= SMEM_MAX


def heads_of(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H·d) → a (B, H, L, d) view of the same storage."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)).transpose(1, 2)


@dataclass(frozen=True)
class Entry:
    """One entry's layout: ``kind`` is ``"qkv"`` (one fused (B, L, 3D)
    tensor), ``"natural"`` (three (B, L, D)) or ``"heads"`` (three
    (B, H, L, d)); ``post`` is the scale contract; ``name`` keys LAUNCHES."""

    name: str
    kind: str
    post: bool

    def views(self, xs, num_heads):
        """The (B, H, L, d) views of q, k, v (or of dq, dk, dv)."""
        if self.kind == "qkv":
            return [heads_of(t, num_heads) for t in xs[0].chunk(3, dim=-1)]
        if self.kind == "natural":
            return [heads_of(t, num_heads) for t in xs]
        return list(xs)

    def out_view(self, t, num_heads):
        """The (B, H, L, d) view of an output-shaped tensor (o or dO)."""
        return t if self.kind == "heads" else heads_of(t, num_heads)

    def new_out(self, xs):
        x = xs[0]
        if self.kind == "qkv":
            return x.new_empty(*x.shape[:-1], x.shape[-1] // 3)
        return torch.empty_like(x)

    def new_grads(self, xs):
        return tuple(torch.empty_like(t) for t in xs)


def _scale(d: int) -> float:
    return 1.0 / d**0.5  # as the TPU kernels compute it


def _scores(q, k, post: bool):
    """f32 scores and the q that dK contracts with."""
    scale = _scale(q.shape[-1])
    if post:
        return (q.float() @ k.float().mT) * scale, q
    qs = (q.float() * scale).to(q.dtype)
    return qs.float() @ k.float().mT, qs


def plain_fwd(q, k, v, post: bool) -> torch.Tensor:
    p = torch.softmax(_scores(q, k, post)[0], dim=-1).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def plain_bwd_f32(q, k, v, g, post: bool):
    """(dq, dk, dv) in f32, before their one rounding, from f32 products of
    rounded operands (the block kernels sum dbqkv from this form)."""
    dt, scale = q.dtype, _scale(q.shape[-1])
    s, qk = _scores(q, k, post)
    p = torch.softmax(s, dim=-1)
    dv = p.to(dt).float().mT @ g.float()
    dp = g.float() @ v.float().mT
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = (ds @ k.float()) * scale
    dk = ds.mT @ qk.float()
    if post:
        dk = dk * scale
    return dq, dk, dv


def plain_bwd(q, k, v, g, post: bool):
    """(dq, dk, dv) in q's dtype."""
    return tuple(t.to(q.dtype) for t in plain_bwd_f32(q, k, v, g, post))


class _Plain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, entry: Entry, num_heads, *xs):
        out = entry.new_out(xs)
        entry.out_view(out, num_heads).copy_(plain_fwd(*entry.views(xs, num_heads), entry.post))
        ctx.save_for_backward(*xs)
        ctx.entry, ctx.num_heads = entry, num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        xs, e, H = ctx.saved_tensors, ctx.entry, ctx.num_heads
        grads = e.new_grads(xs)
        parts = plain_bwd(*e.views(xs, H), e.out_view(g.to(xs[0].dtype), H), e.post)
        for view, part in zip(e.views(grads, H), parts):
            view.copy_(part)
        return (None, None, *grads)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------


def _strides(t: torch.Tensor):
    """(b, h, row) element strides of a (B, H, L, d) view with unit columns."""
    if t.stride(-1) != 1:
        raise ValueError(f"the attention kernel needs unit column stride, got {t.stride()}")
    return t.stride(0), t.stride(1), t.stride(2)


def _launch(entry: Entry, pas: str, ins, outs, o_like) -> None:
    """One kernel launch over (B, H, L, d) views: ``ins`` q, k, v (and, in
    the backward, dO last), ``outs`` o or dq, dk, dv; ``o_like`` is o or dO."""
    q = ins[0]
    B, H, L, d = q.shape
    in_s, out_s = _strides(q), _strides(o_like)
    if any(_strides(t) != in_s for t in (*ins[:3], *(outs if pas == "bwd" else ()))):
        raise ValueError("q, k, v and their gradients must share strides")
    lib = _build.load()
    LAUNCHES[f"{entry.name}_{pas}"] += 1
    fn = lib.ssrl_mha_fwd if pas == "fwd" else lib.ssrl_mha_bwd
    _build.check(fn(
        *(t.data_ptr() for t in (*ins, *outs)), *in_s, *out_s, B, H, L, d,
        _scale(d), int(entry.post), torch.cuda.current_stream(q.device).cuda_stream,
    ), f"{entry.name}_{pas}")


class _Kernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, entry: Entry, num_heads, *xs):
        out = entry.new_out(xs)
        o = entry.out_view(out, num_heads)
        _launch(entry, "fwd", entry.views(xs, num_heads), [o], o)
        ctx.save_for_backward(*xs)
        ctx.entry, ctx.num_heads = entry, num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        xs, e, H = ctx.saved_tensors, ctx.entry, ctx.num_heads
        g = e.out_view(g.to(xs[0].dtype).contiguous(), H)
        grads = e.new_grads(xs)
        _launch(e, "bwd", [*e.views(xs, H), g], e.views(grads, H), g)
        return (None, None, *grads)


def _check_shapes(entry: Entry, xs, num_heads) -> None:
    x = xs[0]
    if any(t.shape != x.shape or t.device != x.device for t in xs):
        raise ValueError(f"{entry.name}: q, k, v differ in shape or device")
    if entry.kind == "heads":
        ok = x.dim() == 4
    else:
        D = x.shape[-1] // 3 if entry.kind == "qkv" else x.shape[-1]
        ok = (x.dim() == 3 and x.shape[-1] % (3 if entry.kind == "qkv" else 1) == 0
              and D % num_heads == 0)
    if not ok:
        raise ValueError(f"{entry.name}: unexpected shape {tuple(x.shape)}"
                         f" for {num_heads} heads")


def _check_cuda(entry: Entry, xs, num_heads) -> None:
    """Raise on what the kernel does not take: bf16 only, and the fit."""
    if xs[0].dtype != torch.bfloat16:
        raise TypeError(f"{entry.name} takes bfloat16 on the card, got {xs[0].dtype}")
    _, _, L, d = entry.views(xs, num_heads)[0].shape
    if not fits(L, d):
        raise ValueError(
            f"{entry.name}: L={L}, d={d} is beyond the kernel's shared-memory fit"
        )


def attend(entry: Entry, xs, num_heads=None) -> torch.Tensor:
    """The entry's attention: the kernel on CUDA, the plain version on CPU."""
    _check_shapes(entry, xs, num_heads)
    dev = xs[0].device.type
    if dev == "cpu":
        return _Plain.apply(entry, num_heads, *xs)
    if dev != "cuda":
        raise ValueError(f"no attention implementation for device {xs[0].device}")
    if any(t.dtype != xs[0].dtype for t in xs):
        raise TypeError(f"{entry.name}: q, k, v differ in dtype")
    _check_cuda(entry, xs, num_heads)
    return _Kernel.apply(entry, num_heads, *(t.contiguous() for t in xs))


def attend_plain(entry: Entry, xs, num_heads=None) -> torch.Tensor:
    """The plain version on any device (the kernel's reference on the card)."""
    _check_shapes(entry, xs, num_heads)
    return _Plain.apply(entry, num_heads, *xs)
