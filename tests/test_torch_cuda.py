"""The CUDA kernels against their plain PyTorch versions, on the card: the
branch GEMM alone (every layout and epilogue against ``gemm_ref``; at f32
the SIMT GEMM of ``csrc/gemm_f32_simt.cuh`` at its tile edges), the
two branch kernels and their f32 kernels (``csrc/branch_f32.cu``: the
forwards held in f32 to 5e-5, the backwards to 1e-4 of each output's largest
magnitude), the whole-block kernel of ``csrc/fused_block.cu``, the
chained-block kernel of ``csrc/block_chain.cu``, the four attention entries
of ``csrc/mha.cu`` (and at f32 of ``csrc/mha_f32.cu``), the fused patch embed
of ``csrc/patch_embed.cu``, the f32 whole block, chain and patch embed
(``csrc/fused_block_f32.cu``, ``block_chain_f32.cu``, ``patch_embed_f32.cu``,
to the same f32 bounds), and f32 training steps against the CPU.

Marked ``cuda`` and skipped without a GPU. The file imports no JAX, so it
also runs where JAX is not installed; ``tests/conftest.py`` does import JAX,
so there run it without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

bf16 unless a test says f32. The forward is held to 6e-2 absolute (the bf16 forward
tolerance of ``tests/test_block_kernel.py``). In the backward both sides
round to bf16 at different points (the plain version's autograd rounds dW,
dP and dy1 to bf16, the kernels keep them in f32), so each of the seven
outputs is held to 2% of its largest magnitude: far below the O(1)
relative error of a layout or indexing fault. The attention entries, the
whole block and the chain are held to the same bounds against their
``*_ref`` versions, which round at the kernel's own points.
"""

import json
import math
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.ops import attention_core as core
from ssrl_vit_mae_jepa_torch.ops import block_chain as bc
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.ops import embed_fused as ef
from ssrl_vit_mae_jepa_torch.ops.attention_core import heads_of
from ssrl_vit_mae_jepa_torch.ops.attention_heads import mha_pallas, mha_pallas_ref
from ssrl_vit_mae_jepa_torch.ops.attention_packed import mha_packed, mha_packed_ref
from ssrl_vit_mae_jepa_torch.ops.attention_stacked import (
    mha_stacked,
    mha_stacked_qkv,
    mha_stacked_qkv_ref,
    mha_stacked_ref,
)
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask

# (B, L, D, H): the MAE encoder and decoder at B=768; the JEPA context
# encoder, predictor (D=96, d=16, F=384) and target encoder at B=768 (also
# the classifier's encoder, whose backward runs there); a head dim of 12
# with ragged L, and the longest sequence the attention backward takes at
# d=32
SHAPES = [(768, 37, 144, 6), (768, 145, 192, 6), (768, 45, 144, 6), (768, 145, 96, 6),
          (768, 145, 144, 6), (3, 17, 48, 4), (2, 160, 64, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(kind, B, L, D, device):
    g = torch.Generator().manual_seed(B + L + D)
    n = 3 * D if kind == "attn" else 4 * D
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    wb_in = D if kind == "attn" else n
    params = [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(n, D) * D**-0.5, 0.1 * rn(n),
              rn(D, wb_in) * wb_in**-0.5, 0.1 * rn(D)]
    x = rn(B, L, D).to(torch.bfloat16)
    dy = rn(B, L, D).to(torch.bfloat16)
    return x.to(device), dy.to(device), [p.to(device) for p in params]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("B,L,D,H", SHAPES)
def test_kernel_matches_plain(cuda, kind, B, L, D, H):
    x, dy, params = _inputs(kind, B, L, D, cuda)
    extra = (H,) if kind == "attn" else ()
    kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
    ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref

    def run(fn):
        leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
        out = fn(*leaves, *extra)
        return out.detach(), torch.autograd.grad(out, leaves, dy)

    before = dict(bf.LAUNCHES)
    out_k, grads_k = run(kern)
    out_r, grads_r = run(ref)
    fwd, bwd = f"{kind}_branch_fwd", f"{kind}_branch_bwd"
    assert bf.LAUNCHES[fwd] == before[fwd] + 1 and bf.LAUNCHES[bwd] == before[bwd] + 1
    before = dict(bf.LAUNCHES)
    with torch.no_grad():
        out_ns = kern(x, *params, *extra)
    torch.cuda.synchronize()
    assert torch.equal(out_ns, out_k)  # the no-stash forward: same bits
    nograd = "attn_branch_fwd_nograd" if kind == "attn" else fwd
    assert {k: v - before[k] for k, v in bf.LAUNCHES.items() if v != before[k]} == {nograd: 1}
    torch.testing.assert_close(out_k.float(), out_r.float(), atol=6e-2, rtol=0)
    for a, b in zip(grads_k, grads_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        bound = 2e-2 * b.float().abs().max().item() + 1e-3
        torch.testing.assert_close(a.float(), b.float(), atol=bound, rtol=0)


@pytest.mark.cuda
def test_cuda_rejects_float16(cuda):
    """Every kernel takes bf16 and f32 and refuses any other dtype: the
    branches, the whole block, the chain and the fused patch embed refuse
    float16."""
    x, _, params = _inputs("mlp", 2, 5, 16, cuda)
    with pytest.raises(TypeError):
        bf.fused_mlp_branch(x.half(), *params)
    xb, _, bparams = _stack_inputs(2, 17, 48, 2, cuda)
    with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
        bf.fused_block(xb.half(), bparams[0], 4)
    with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
        bc.fused_block_chain(xb.half(), bparams, 4)
    patches, eparams, idx, _ = _embed_inputs(2, 20, 48, 40, 7, cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ef.fused_patch_embed(patches.half(), *eparams, idx)


# (B, L, D, H) of the f32 forwards: the feature extractor's encoder at its
# default batch, the reconstruction's encoder and decoder at --num_images 8,
# and two odd shapes (head dim 12 with ragged L; L=200 at d=32)
F32_SHAPES = [(256, 145, 144, 6), (8, 37, 144, 6), (8, 145, 192, 6), (3, 17, 48, 4),
              (2, 200, 64, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("B,L,D,H", F32_SHAPES)
def test_f32_kernel_matches_plain(cuda, kind, B, L, D, H):
    """``csrc/branch_f32.cu`` against the plain f32 version on the card with
    TF32 off: unit-scale inputs, atol 5e-5 (the f32 tolerance of
    tests/test_block_kernel.py); one launch, and no bf16 kernel."""
    x, _, params = _inputs(kind, B, L, D, cuda)
    x = x.float()
    extra = (H,) if kind == "attn" else ()
    kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
    ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref
    name = "attn_branch_fwd_nograd_f32" if kind == "attn" else "mlp_branch_fwd_f32"
    before = dict(bf.LAUNCHES)
    with torch.no_grad():
        out = kern(x, *params, *extra)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in bf.LAUNCHES.items() if v != before[k]} == {name: 1}
        want = ref(x, *params, *extra)
    assert out.dtype == torch.float32 and out.shape == x.shape
    torch.testing.assert_close(out, want, atol=5e-5, rtol=0)
    with torch.no_grad():
        assert torch.equal(kern(x, *params, *extra), out)  # deterministic


@pytest.mark.cuda
def test_f32_encoder_forward_launches_only_the_f32_kernels(cuda):
    """An f32 ViT under no_grad (the feature extractor's forward): one f32
    launch of each branch per block, no bf16 branch kernel."""
    from ssrl_vit_mae_jepa_torch.models.vit import VisionTransformer

    vit = VisionTransformer(embed_dim=48, depth=3, num_heads=4, dtype=torch.float32)
    vit.init_weights(torch.Generator().manual_seed(0))
    vit.to(cuda).eval()
    images = torch.randn(4, 96, 96, 3, device=cuda)
    _reset()
    with torch.no_grad():
        out = vit(images)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert _launched() == {"attn_branch_fwd_nograd_f32": 3, "mlp_branch_fwd_f32": 3}
    vit_cpu = VisionTransformer(embed_dim=48, depth=3, num_heads=4, dtype=torch.float32)
    vit_cpu.load_state_dict({k: v.cpu() for k, v in vit.state_dict().items()})
    with torch.no_grad():
        want = vit_cpu(images.cpu())
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=0)


# (B, L, D, H) of the f32 training kernels: F32_SHAPES and the JEPA
# predictor's head dim 16
F32_GRAD_SHAPES = F32_SHAPES + [(64, 145, 96, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("B,L,D,H", F32_GRAD_SHAPES)
def test_f32_grad_kernels_match_plain(cuda, kind, B, L, D, H):
    """The f32 training kernels of ``csrc/branch_f32.cu`` (the attention
    branch's stash forward and backward, the MLP branch's forward under grad
    and backward) against autograd over the plain f32 versions with TF32
    off: the forward within 5e-5, each of the seven backward outputs within
    1e-4 of its largest magnitude (+1e-6; f32 sums in another order move it
    by ~1e-6 of that, a layout fault by O(1)); one launch each way and no
    other kernel; the no-grad forward and a second backward equal bit for
    bit (no atomics)."""
    x, dy, params = _inputs(kind, B, L, D, cuda)
    x, dy = x.float(), dy.float()
    extra = (H,) if kind == "attn" else ()
    kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
    ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    _reset()
    out = kern(*leaves, *extra)
    grads = torch.autograd.grad(out, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()
    assert _launched() == {f"{kind}_branch_fwd_f32": 1, f"{kind}_branch_bwd_f32": 1}
    assert all(torch.equal(a, b) for a, b in
               zip(grads, torch.autograd.grad(out, leaves, dy, retain_graph=True)))
    with torch.no_grad():
        assert torch.equal(kern(x, *params, *extra), out)
    out_r = ref(*leaves, *extra)
    grads_r = torch.autograd.grad(out_r, leaves, dy)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, out_r, atol=5e-5, rtol=0)
    for a, b in zip(grads, grads_r):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item() + 1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the whole block and the chain
# ---------------------------------------------------------------------------


def _block_params(D, device, seed):
    """One block's 12 f32 parameters, torch layout, at realistic scales."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    F_ = 4 * D
    ps = [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(3 * D, D) * D**-0.5, 0.1 * rn(3 * D),
          rn(D, D) * D**-0.5, 0.1 * rn(D), 1.0 + 0.1 * rn(D), 0.1 * rn(D),
          rn(F_, D) * D**-0.5, 0.1 * rn(F_), rn(D, F_) * F_**-0.5, 0.1 * rn(D)]
    return [t.to(device) for t in ps]


def _stack_inputs(B, L, D, N, device):
    g = torch.Generator().manual_seed(B + L + D + N)
    x, dy = (torch.randn(B, L, D, generator=g).to(torch.bfloat16).to(device) for _ in range(2))
    return x, dy, [_block_params(D, device, seed=D + k) for k in range(N)]


def _stack_run(fn, x, dy, params_list):
    """fn(x, params_list) with grad: (output, dx and every parameter's grad)."""
    xl = x.clone().requires_grad_()
    pl = [[t.clone().requires_grad_() for t in p] for p in params_list]
    out = fn(xl, pl)
    return out.detach(), torch.autograd.grad(out, [xl] + [t for p in pl for t in p], dy)


def _close(out_k, grads_k, out_r, grads_r, fwd_atol=6e-2):
    """Forward within ``fwd_atol``, each gradient within 2% of the plain
    version's largest magnitude; the message lists every output's error."""
    assert out_k.dtype == torch.bfloat16 and out_k.shape == out_r.shape
    assert len(grads_k) == len(grads_r)
    errs = [((out_k.float() - out_r.float()).abs().max().item(), fwd_atol)]
    for a, b in zip(grads_k, grads_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        errs.append(((a.float() - b.float()).abs().max().item(),
                     2e-2 * b.float().abs().max().item() + 1e-3))
    assert all(e <= lim for e, lim in errs), [f"{e:.3g}/{lim:.3g}" for e, lim in errs]


def _mono(H):
    return lambda x, pl: bf.fused_block(x, pl[0], H)


def _mono_ref(H):
    return lambda x, pl: bf.block_ref(x, pl[0], H)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H", SHAPES)
def test_block_kernel_matches_plain(cuda, B, L, D, H):
    """Forward and all 13 backward outputs of the whole block; one launch of
    each entry; the no-grad forward gives the same bits."""
    x, dy, params = _stack_inputs(B, L, D, 1, cuda)
    before = dict(bf.LAUNCHES)
    out_k, grads_k = _stack_run(_mono(H), x, dy, params)
    assert {k: v - before[k] for k, v in bf.LAUNCHES.items() if v != before[k]} == {
        "block_fwd": 1, "block_bwd": 1, "mlp_half_fwd": 1, "mlp_half_bwd": 1}
    out_r, grads_r = _stack_run(_mono_ref(H), x, dy, params)
    with torch.no_grad():
        out_ng = bf.fused_block(x, params[0], H)
    torch.cuda.synchronize()
    assert torch.equal(out_ng, out_k) and bf.LAUNCHES["block_fwd_nograd"] == before[
        "block_fwd_nograd"] + 1
    _close(out_k, grads_k, out_r, grads_r)


# (B, L, D, H, N): the five stacks of the flagship steps at B=768 (MAE
# encoder and decoder, JEPA context encoder, predictor, target encoder) and
# a ragged small one
CHAIN_SHAPES = [(768, 37, 144, 6, 4), (768, 145, 192, 6, 2), (768, 45, 144, 6, 4),
                (768, 145, 96, 6, 2), (768, 145, 144, 6, 4), (3, 17, 48, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H,N", CHAIN_SHAPES)
def test_chain_kernel_matches_plain(cuda, B, L, D, H, N):
    """Forward and all 12·N + 1 backward outputs of the chain; the no-grad
    forward (nothing stashed) gives the stash forward's bits."""
    x, dy, params = _stack_inputs(B, L, D, N, cuda)
    before = dict(bc.LAUNCHES)
    out_k, grads_k = _stack_run(lambda x, pl: bc.fused_block_chain(x, pl, H), x, dy, params)
    with torch.no_grad():
        out_ng = bc.fused_block_chain(x, params, H)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in bc.LAUNCHES.items() if v != before[k]} == {
        "chain_fwd": 1, "chain_fwd_nograd": 1, "chain_bwd": 1}
    assert torch.equal(out_ng, out_k)
    with torch.no_grad():  # the chain's forward is the split kernels' bit for bit
        y = x
        for p in params:
            y = bf.fused_attn_branch(y, *p[:6], H)
            y = bf.fused_mlp_branch(y, *p[6:])
    assert torch.equal(y, out_k)
    out_r, grads_r = _stack_run(lambda x, pl: bc.chain_ref(x, pl, H), x, dy, params)
    # the bf16 forward tolerance per block: a rounding that flips in one
    # block carries into the next
    _close(out_k, grads_k, out_r, grads_r, fwd_atol=6e-2 * N)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mono", "chain", "mlp_half"])
def test_block_kernels_are_deterministic(cuda, kind):
    """Repeated calls on the same inputs give the same bits (no atomics:
    every sum is a fixed-order reduction); ``mlp_half`` runs the MLP-half
    kernels of ``csrc/block_mlp.cu`` alone, the whole block's (z in f32)."""
    B, L, D, H = 768, 145, 192, 6
    x, dy, params = _stack_inputs(B, L, D, 2 if kind == "chain" else 1, cuda)
    fn = (lambda x, pl: bc.fused_block_chain(x, pl, H)) if kind == "chain" else _mono(H)
    if kind == "mlp_half":
        fn = lambda x, pl: _HalfFn.apply(x, False, *pl[0])  # noqa: E731
        params = [params[0][6:]]
    first = _stack_run(fn, x, dy, params)
    for _ in range(2):
        out, grads = _stack_run(fn, x, dy, params)
        assert torch.equal(out, first[0])
        assert all(torch.equal(a, b) for a, b in zip(grads, first[1]))


class _HalfFn(torch.autograd.Function):
    """The MLP-half kernels alone as one autograd step: forward
    ``bf.mlp_half``, backward ``bf.mlp_half_bwd`` (dx rounded to bf16)."""

    @staticmethod
    def forward(ctx, x, round_z, *p):
        ctx.save_for_backward(x, *p)
        ctx.round_z = round_z
        return bf.mlp_half(x, p, round_z)

    @staticmethod
    def backward(ctx, g):
        x, *p = ctx.saved_tensors
        dx, grads = bf.mlp_half_bwd(x, p, g.float(), ctx.round_z)
        return (dx.to(x.dtype), None, *grads)




# (B, L, D): the MLP half at the five block geometries (MAE encoder and
# decoder, JEPA context encoder, predictor, target encoder and classifier),
# F = 4D, and at ragged row counts (M = 51 and 333, not multiples of 128)
# with a D of 48 and 144
HALF_SHAPES = [(768, 37, 144), (768, 145, 192), (768, 45, 144), (768, 145, 96),
               (768, 145, 144), (3, 17, 48), (9, 37, 144)]


@pytest.mark.cuda
@pytest.mark.parametrize("round_z", [True, False])
@pytest.mark.parametrize("B,L,D", HALF_SHAPES)
def test_mlp_half_matches_plain(cuda, B, L, D, round_z):
    """The MLP-half kernels of ``csrc/block_mlp.cu`` against
    ``mlp_fwd_plain`` / ``mlp_bwd_plain`` on the card, z rounded (the
    chain) and in f32 (the whole block): the forward within 6e-2, the f32
    input gradient (with the output gradient added) and the six parameter
    gradients within 2% of their largest magnitudes; with z rounded the
    forward equals the split MLP branch's bit for bit."""
    x, dy, params = _stack_inputs(B, L, D, 1, cuda)
    p = params[0][6:]
    g = torch.Generator().manual_seed(D)
    gy = (torch.randn(B, L, D, generator=g) * 0.5).to(cuda)
    _reset()
    out = bf.mlp_half(x, p, round_z)
    dx32, grads = bf.mlp_half_bwd(x, p, gy, round_z)
    torch.cuda.synchronize()
    assert _launched() == {"mlp_half_fwd": 1, "mlp_half_bwd": 1}
    out_r = bf.mlp_fwd_plain(x, p, round_z)
    dx_r, grads_r = bf.mlp_bwd_plain(x, p, gy, round_z)
    assert out.dtype == torch.bfloat16 and dx32.dtype == torch.float32
    torch.testing.assert_close(out.float(), out_r.float(), atol=6e-2, rtol=0)
    for a, b in zip((dx32, *grads), (dx_r, *grads_r)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        bound = 2e-2 * b.float().abs().max().item() + 1e-3
        torch.testing.assert_close(a, b.float(), atol=bound, rtol=0)
    if round_z:
        with torch.no_grad():
            assert torch.equal(out, bf.fused_mlp_branch(x, *p))


def _kernel_names(fn):
    """Device kernel name -> launches of one call of ``fn`` (after a warm-up
    call), under ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}


def _epis(names):
    """The epilogues (``ssrl::Epi``) of the branch GEMM's launches, each as
    often as it ran."""
    out = []
    for name, n in names.items():
        m = re.search(r"gemm_sm90_kernel<\w+, \w+, \d+, (\d+)>", name)
        if m:
            out += [int(m.group(1))] * n
    return sorted(out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mono", "chain"])
def test_block_kernels_launch_ln1_and_qkv_once(cuda, kind):
    """By the profiler's kernel names, per call: the whole block's backward
    runs LN1 and the qkv product (the NT bias epilogue) once, the chain's
    once a block; neither runs a GELU epilogue of the branch GEMM (no z to
    write or read: the MLP half is one kernel each way, one a block)."""
    B, L, D, H = 96, 37, 144, 6
    N = 2 if kind == "chain" else 1
    x, dy, params = _stack_inputs(B, L, D, N, cuda)
    fn = (lambda x, pl: bc.fused_block_chain(x, pl, H)) if kind == "chain" else _mono(H)
    xl = x.clone().requires_grad_()
    pl = [[t.clone().requires_grad_() for t in p] for p in params]
    out = fn(xl, pl)
    leaves = [xl] + [t for p in pl for t in p]
    bwd = _kernel_names(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))
    with torch.no_grad():
        fwd = _kernel_names(lambda: fn(x, params))

    def count(names, part):
        return sum(n for k, n in names.items() if part in k)

    for names, half in ((fwd, "mlp_half_fwd_kernel"), (bwd, "mlp_half_bwd_kernel")):
        assert count(names, half) == N
        assert count(names, "ln_fwd_kernel") == N  # LN1 only: LN2 is in the half
        assert not set(_epis(names)) & {4, 5, 6, 7}  # EPI_*GELU*
    assert _epis(bwd).count(2) == N  # EPI_BIAS_BF16: the qkv product


def _f32_close(out_k, grads_k, out_r, grads_r):
    """f32 against the plain version: the forward within 5e-5, each gradient
    within 1e-4 of its largest magnitude (+1e-6); f32 sums in another order
    move them by ~1e-6 of that, a TF32 product or a layout fault by far more."""
    assert out_k.dtype == torch.float32 and out_k.shape == out_r.shape
    torch.testing.assert_close(out_k, out_r, atol=5e-5, rtol=0)
    assert len(grads_k) == len(grads_r)
    for a, b in zip(grads_k, grads_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=1e-4 * b.float().abs().max().item() + 1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mono", "chain"])
def test_f32_block_kernels_match_plain(cuda, kind):
    """``csrc/fused_block_f32.cu`` at (2, 17, 48, H=4) and
    ``csrc/block_chain_f32.cu`` with N=2 against ``block_ref`` /
    ``chain_ref`` at f32: the forward and every backward output (dx and the
    12 gradients a block), one launch each way under the f32 key and no
    other kernel; the no-grad forward and a second call equal bit for bit."""
    B, L, D, H = 2, 17, 48, 4
    N = 2 if kind == "chain" else 1
    x, dy, params = _stack_inputs(B, L, D, N, cuda)
    x, dy = x.float(), dy.float()
    if kind == "chain":
        fn, ref = (lambda x, pl: bc.fused_block_chain(x, pl, H)), (
            lambda x, pl: bc.chain_ref(x, pl, H))
        fwd, nograd, bwd = "chain_fwd_f32", "chain_fwd_nograd_f32", "chain_bwd_f32"
    else:
        fn, ref = _mono(H), _mono_ref(H)
        fwd, nograd, bwd = "block_fwd_f32", "block_fwd_nograd_f32", "block_bwd_f32"
    _reset()
    out_k, grads_k = _stack_run(fn, x, dy, params)
    torch.cuda.synchronize()
    assert _launched() == {fwd: 1, bwd: 1}
    out_2, grads_2 = _stack_run(fn, x, dy, params)
    assert torch.equal(out_2, out_k) and all(map(torch.equal, grads_2, grads_k))
    _reset()
    with torch.no_grad():
        out_ng = fn(x, params)
    torch.cuda.synchronize()
    assert _launched() == {nograd: 1} and torch.equal(out_ng, out_k)
    out_r, grads_r = _stack_run(ref, x, dy, params)
    _f32_close(out_k, grads_k, out_r, grads_r)


# (B, L, D, F): the f32 MLP half at the MAE encoder and decoder and the JEPA
# predictor's widths, ragged row counts (not multiples of 64), and widths
# that take the 4-byte copies (D or F not a multiple of 4) or pad D to 48
F32_HALF_SHAPES = [(96, 37, 144, 576), (64, 145, 192, 768), (48, 145, 96, 384),
                   (3, 17, 48, 192), (9, 37, 144, 576), (2, 5, 45, 180), (2, 7, 40, 100),
                   (3, 11, 256, 1024), (1, 1, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,F_", F32_HALF_SHAPES)
def test_f32_mlp_half_matches_plain(cuda, B, L, D, F_):
    """The f32 MLP half of ``csrc/block_mlp_f32.cu`` alone against
    ``mlp_fwd_plain`` / ``mlp_bwd_plain`` at f32 (TF32 off): one launch each
    way under the ``_f32`` keys; the forward within 5e-5 and equal to the
    split f32 MLP branch's bit for bit (fc1 over K = D and fc2 over K = F in
    ascending k, LN2 in ``ln_f32_kernel``'s order); the input gradient and
    the six parameter gradients within 1e-4 of their largest magnitudes; a
    second call the same bits."""
    g = torch.Generator().manual_seed(B + L + D + F_)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    p = [t.to(cuda) for t in (1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(F_, D) * D**-0.5,
                               0.1 * rn(F_), rn(D, F_) * F_**-0.5, 0.1 * rn(D))]
    x, gy = rn(B, L, D).to(cuda), rn(B, L, D).to(cuda)
    _reset()
    out = bf.mlp_half(x, p)
    dx, grads = bf.mlp_half_bwd(x, p, gy)
    torch.cuda.synchronize()
    assert _launched() == {"mlp_half_fwd_f32": 1, "mlp_half_bwd_f32": 1}
    with torch.no_grad():
        assert torch.equal(out, bf.fused_mlp_branch(x, *p))
    again = bf.mlp_half_bwd(x, p, gy)
    assert torch.equal(bf.mlp_half(x, p), out)
    assert all(map(torch.equal, (dx, *grads), (again[0], *again[1])))
    dx_r, grads_r = bf.mlp_bwd_plain(x, p, gy, True)
    _f32_close(out, (dx, *grads), bf.mlp_fwd_plain(x, p), (dx_r, *grads_r))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mono", "chain"])
def test_f32_block_kernels_launch_ln1_and_qkv_once(cuda, kind):
    """By the profiler's kernel names, per call at f32: the whole block's
    backward runs LN1 and the qkv product (the SIMT GEMM's F_BIAS epilogue)
    once, kept from its recomputing forward. ``ln_f32_kernel`` runs LN1 and
    LN2 (the split MLP branch's), so twice a block in each of the block's
    passes and the chain's forwards. The chain's training forward keeps
    LN1's and LN2's outputs, qkv, z and h (the fc1 product with z,
    F_BIAS_GELU_Z, once a block), so its backward runs no LN forward, no
    qkv product and no fc1 product."""
    B, L, D, H = 96, 37, 144, 6
    N = 2 if kind == "chain" else 1
    x, dy, params = _stack_inputs(B, L, D, N, cuda)
    x, dy = x.float(), dy.float()
    fn = (lambda x, pl: bc.fused_block_chain(x, pl, H)) if kind == "chain" else _mono(H)
    xl = x.clone().requires_grad_()
    pl = [[t.clone().requires_grad_() for t in p] for p in params]
    out = fn(xl, pl)
    leaves = [xl] + [t for p in pl for t in p]
    bwd = _kernel_names(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))
    train = _kernel_names(lambda: fn(xl, pl))
    with torch.no_grad():
        fwd = _kernel_names(lambda: fn(x, params))

    def count(names, part):
        return sum(n for k, n in names.items() if part in k)

    def epis(names):
        out = []
        for name, n in names.items():
            m = re.search(r"gemm_f32_kernel<\w+, \w+, \d+, \d+, \d+, (\d+)>", name)
            if m:
                out += [int(m.group(1))] * n
        return sorted(out)

    for names in (fwd, train) + ((bwd,) if kind == "mono" else ()):
        assert count(names, "ln_f32_kernel") == 2 * N  # LN1 and LN2
        assert epis(names).count(1) == N  # F_BIAS: the qkv product
    if kind == "chain":
        assert epis(train).count(4) == N and epis(fwd).count(4) == 0  # F_BIAS_GELU_Z
        assert count(bwd, "ln_f32_kernel") == 0
        assert epis(bwd).count(1) == 0 and epis(bwd).count(4) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H,N", [(96, 37, 144, 6, 4), (64, 145, 192, 6, 2),
                                       (3, 17, 48, 4, 2), (2, 5, 40, 4, 3)])
def test_f32_chain_backward_is_the_split_pair(cuda, B, L, D, H, N):
    """The f32 chain's backward, from the stash of its training forward
    (no qkv or fc1 product again), gives the split f32 pair's gradients
    (the attention and MLP branches through autograd) bit for bit, and a
    second backward over the same stash gives the same bits."""
    x, dy, params = _stack_inputs(B, L, D, N, cuda)
    x, dy = x.float(), dy.float()
    xl = x.clone().requires_grad_()
    pl = [[t.clone().requires_grad_() for t in p] for p in params]
    leaves = [xl] + [t for p in pl for t in p]
    out = bc.fused_block_chain(xl, pl, H)
    grads = torch.autograd.grad(out, leaves, dy, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dy)
    assert all(map(torch.equal, grads, again))

    def split(x, pl):
        for p in pl:
            x = bf.fused_mlp_branch(bf.fused_attn_branch(x, *p[:6], H), *p[6:])
        return x

    out_s, grads_s = _stack_run(split, x, dy, params)
    assert torch.equal(out.detach(), out_s)
    assert [i for i, (a, b) in enumerate(zip(grads, grads_s)) if not torch.equal(a, b)] == []


@pytest.mark.cuda
def test_block_kernels_refuse_what_they_do_not_take(cuda):
    x, _, params = _stack_inputs(2, 17, 48, 2, cuda)
    with pytest.raises(TypeError):
        bf.fused_block(x.half(), params[0], 4)
    with pytest.raises(TypeError):
        bc.fused_block_chain(x.half(), params, 4)
    with pytest.raises(ValueError):  # a CPU parameter with a CUDA activation
        bf.fused_block(x, [params[0][0].cpu()] + params[0][1:], 4)
    long, _, lparams = _stack_inputs(2, 257, 64, 2, cuda)  # d=32, L > 256
    with pytest.raises(ValueError, match="do not take"):
        bf.fused_block(long, lparams[0], 2)
    with pytest.raises(ValueError, match="do not take"):
        bc.fused_block_chain(long, lparams, 2)


# ---------------------------------------------------------------------------
# the branch GEMM alone (csrc/gemm_sm90.cuh through ssrl_gemm)
# ---------------------------------------------------------------------------

# (M, N, K) as ``gemm`` names them (tn: M output rows = the operands' row
# length, K = the B*L rows): flagship products (the MAE encoder's qkv and
# fc1, the decoder's dy2 and dz, the weight gradients dWqkv and dW2), a
# ragged M with D = 40 (a K tail of 40 < 64), K = 168 (two chunks and a
# tail), N tiles of 96 / 144 / 192 and their splits, one row
GEMM_SHAPES = {
    "nt": [(28416, 432, 144), (28416, 576, 144), (111360, 192, 768), (333, 40, 40),
           (77, 120, 168), (129, 288, 96), (1, 8, 8)],
    "nn": [(111360, 192, 768), (111360, 768, 192), (28416, 144, 432), (333, 40, 40),
           (77, 120, 168), (129, 384, 96), (1, 8, 8)],
    "tn": [(432, 144, 28416), (192, 768, 111360), (768, 192, 111360), (40, 40, 333),
           (120, 168, 77), (96, 384, 5000), (8, 8, 1)],
}


def _gemm_operands(layout, M, N, K, device, seed=0):
    g = torch.Generator().manual_seed(seed + M + N + K)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    a = rn(K, M) if layout == "tn" else rn(M, K)
    b = (rn(N, K) if layout == "nt" else rn(K, N)) * K**-0.5
    extra = dict(bias=0.1 * rn(N), resid=rn(M, N), z=rn(M, N))
    bf16 = lambda t: t.to(torch.bfloat16).to(device)  # noqa: E731
    return bf16(a), bf16(b), {k: bf16(v) for k, v in extra.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("layout,epi,M,N,K", [
    (lay, e, *shape) for lay, es in bf.GEMM_EPIS.items() for e in es
    for shape in GEMM_SHAPES[lay]])
def test_gemm_matches_plain(cuda, layout, epi, M, N, K):
    """Each output within 1% of the plain version's largest magnitude (a
    bf16 rounding that flips is one unit in the last place; a layout or
    swizzle fault is O(1)); one launch; the same bits on a second call."""
    a, b, ex = _gemm_operands(layout, M, N, K, cuda)
    if epi == "gelu32_bwd":
        ex["z"] = ex["z"].float()
    before = bf.LAUNCHES["gemm"]
    got = bf.gemm(a, b, layout, epi, **ex)
    assert bf.LAUNCHES["gemm"] == before + 1
    want = bf.gemm_ref(a, b, layout, epi, **ex)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        err = (x.float() - y.float()).abs().max().item()
        assert err <= 1e-2 * y.float().abs().max().item() + 1e-4, (err, y.float().abs().max())
    again = bf.gemm(a, b, layout, epi, **ex)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_gemm_refuses_what_it_does_not_take(cuda):
    a, b, ex = _gemm_operands("nt", 64, 16, 16, cuda)
    with pytest.raises(TypeError):
        bf.gemm(a.half(), b.half(), "nt", "bias_bf16", bias=ex["bias"])
    with pytest.raises(TypeError):
        bf.gemm(a.float(), b, "nt", "bias_bf16", bias=ex["bias"])
    with pytest.raises(ValueError, match="M, N, K >= 1"):
        bf.gemm(a.float()[:, :0], b.float()[:, :0], "nt", "bias_bf16", bias=ex["bias"].float())
    with pytest.raises(ValueError, match="multiples of 8"):
        bf.gemm(a[:, :12].contiguous(), b[:, :12].contiguous(), "nt", "bias_bf16",
                bias=ex["bias"])
    with pytest.raises(ValueError, match="epilogues"):
        bf.gemm(a, b, "nt", "f32")


# ---------------------------------------------------------------------------
# the f32 branch GEMM alone (csrc/gemm_f32_simt.cuh through ssrl_gemm_f32)
# ---------------------------------------------------------------------------

# the edges of its tiles: M around its 64- and 128-row blocks, N at the
# block widths (48-192, and 432 = three 144-column blocks), K around its
# 16-deep stages; each NT case with the GELU epilogue (h and z), each NN
# case with the GELU backward (dz and its column sums)
F32_EDGE_M = (1, 17, 127, 129)
F32_EDGE_N = (48, 96, 144, 432)
F32_EDGE_K = (48, 144, 768)
F32_GEMM_CASES = (
    [("nt", "bias_gelu", M, N, K) for M in F32_EDGE_M for N in F32_EDGE_N for K in F32_EDGE_K]
    + [("nn", "gelu_bwd", M, N, K) for M in F32_EDGE_M for N in F32_EDGE_N for K in F32_EDGE_K]
    # every other epilogue once
    + [("nt", e, 129, 432, 144) for e in ("bias_bf16", "bias_resid", "bias_gelu32")]
    + [("nn", e, 129, 432, 144) for e in ("f32", "bf16", "gelu32_bwd")]
    # TN over a row count that no chunk divides, out as it is and
    # transposed (the plan swaps A and B where that pads less), one row
    + [("tn", "f32", M, N, K) for M, N, K in ((144, 576, 5003), (576, 144, 5003),
                                              (432, 144, 28423), (96, 96, 111361),
                                              (192, 768, 7777), (48, 48, 1))]
    # rows that are not 16-byte aligned: 4-byte copies and scalar stores
    + [("nt", "bias_resid", 77, 45, 45), ("nn", "gelu_bwd", 77, 45, 30),
       ("tn", "f32", 17, 45, 333)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,epi,M,N,K", F32_GEMM_CASES)
def test_gemm_f32_matches_plain(cuda, layout, epi, M, N, K):
    """The f32 GEMM against ``gemm_ref`` at f32 (cuBLAS with TF32 off): the
    forward products (NT) within 5e-5 on unit-scale operands, the gradient
    products (NN, TN) within 1e-4 of the plain output's largest magnitude
    (+1e-6): f32 sums in another order move them by ~1e-6, a tile or layout
    fault by O(1); one launch; a second call the same bits."""
    g = torch.Generator().manual_seed(M + N + K)
    rn = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    a = rn(K, M) if layout == "tn" else rn(M, K)
    b = (rn(N, K) if layout == "nt" else rn(K, N)) * K**-0.5
    ex = dict(bias=0.1 * rn(N), resid=rn(M, N), z=rn(M, N))
    before = bf.LAUNCHES["gemm_f32"]
    got = bf.gemm(a, b, layout, epi, **ex)
    assert bf.LAUNCHES["gemm_f32"] == before + 1
    want = bf.gemm_ref(a, b, layout, epi, **ex)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.float32 and x.shape == y.shape
        lim = 5e-5 if layout == "nt" else 1e-4 * y.abs().max().item() + 1e-6
        torch.testing.assert_close(x, y, atol=lim, rtol=0)
    again = bf.gemm(a, b, layout, epi, **ex)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# entry -> (kernel wrapper, plain version); each called as in _attention_run
ATTENTION = {
    "mha_stacked_qkv": (mha_stacked_qkv, mha_stacked_qkv_ref),
    "mha_stacked": (mha_stacked, mha_stacked_ref),
    "mha_packed": (mha_packed, mha_packed_ref),
    "mha_pallas": (mha_pallas, mha_pallas_ref),
}
# (B, L, D, H): encoder, decoder, JEPA predictor at B=768; ragged small
# shapes at head dims 12 and 8; the longest L the kernel took at d=32 and
# d=16 when it kept whole-head P and dS in shared memory, and the longest it
# takes now; then ragged L at every head dim (one 16-row strip and its
# edges, several heads a block at L < 96, one head a block beyond)
ATTN_SHAPES = [(768, 37, 144, 6), (768, 145, 192, 6), (768, 145, 96, 6),
               (3, 17, 48, 4), (2, 23, 16, 2), (2, 160, 64, 2), (2, 176, 32, 2),
               (2, 256, 64, 2)]
ATTN_SHAPES += [(3, L, 2 * d, 2) for L in (1, 15, 16, 17, 33, 48, 144) for d in (8, 16, 24, 32)]


def _attention_inputs(entry, B, L, D, H, device, dtype=torch.bfloat16):
    """The entry's leaves (q, k, v; or one fused qkv) and dO, on the card."""
    g = torch.Generator().manual_seed(B + L + D)
    q, k, v, do = (torch.randn(B, L, D, generator=g).to(dtype).to(device) for _ in range(4))
    if entry == "mha_stacked_qkv":
        return [torch.cat([q, k, v], dim=-1)], do
    if entry == "mha_pallas":
        return [heads_of(t, H).contiguous() for t in (q, k, v)], heads_of(do, H).contiguous()
    return [q, k, v], do


def _attention_call(entry, fn, leaves, H):
    return fn(*leaves) if entry == "mha_pallas" else fn(*leaves, H)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H", ATTN_SHAPES)
@pytest.mark.parametrize("entry", list(ATTENTION))
def test_attention_kernel_matches_plain(cuda, entry, B, L, D, H):
    kern, ref = ATTENTION[entry]
    leaves, do = _attention_inputs(entry, B, L, D, H, cuda)

    def run(fn):
        xs = [t.clone().requires_grad_() for t in leaves]
        out = _attention_call(entry, fn, xs, H)
        return out.detach(), torch.autograd.grad(out, xs, do)

    before = dict(core.LAUNCHES)
    out_k, grads_k = run(kern)
    assert core.LAUNCHES[f"{entry}_fwd"] == before[f"{entry}_fwd"] + 1
    assert core.LAUNCHES[f"{entry}_bwd"] == before[f"{entry}_bwd"] + 1
    out_r, grads_r = run(ref)
    with torch.no_grad():
        out_ng = _attention_call(entry, kern, leaves, H)
    torch.cuda.synchronize()
    assert torch.equal(out_ng, out_k)
    assert out_k.dtype == torch.bfloat16 and out_k.shape == out_r.shape
    torch.testing.assert_close(out_k.float(), out_r.float(), atol=6e-2, rtol=0)
    for a, b in zip(grads_k, grads_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        bound = 2e-2 * b.float().abs().max().item() + 1e-3
        torch.testing.assert_close(a.float(), b.float(), atol=bound, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ATTENTION))
def test_attention_kernel_is_deterministic(cuda, entry):
    """Two backward calls on the same inputs give the same bits (no
    atomics: every sum has one order)."""
    B, L, D, H = 768, 145, 192, 6
    leaves, do = _attention_inputs(entry, B, L, D, H, cuda)
    xs = [t.clone().requires_grad_() for t in leaves]
    out = _attention_call(entry, ATTENTION[entry][0], xs, H)
    first = torch.autograd.grad(out, xs, do, retain_graph=True)
    again = torch.autograd.grad(out, xs, do)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H", [(64, 37, 144, 6), (64, 145, 192, 6), (3, 17, 48, 4)])
def test_branch_dbqkv_is_the_column_sums_of_dqkv(cuda, B, L, D, H):
    """The attention branch's dbqkv, summed from the attention core's
    per-image column sums (``colpart``), against the column sums of dq | dk |
    dv from the attention kernel run alone on the branch's qkv and da."""
    x, dy, params = _inputs("attn", B, L, D, cuda)
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    dbqkv = torch.autograd.grad(bf.fused_attn_branch(*leaves, H), leaves, dy)[4]
    ln_s, ln_b, wqkv, bqkv, wp, _ = params
    dt = torch.bfloat16
    y1 = bf.layer_norm(x, ln_s, ln_b).to(dt)
    qkv = (y1.float() @ wqkv.to(dt).float().t() + bqkv.to(dt).float()).to(dt).requires_grad_()
    da = (dy.float() @ wp.to(dt).float()).to(dt)
    (dqkv,) = torch.autograd.grad(mha_stacked_qkv(qkv, H), [qkv], da)
    want = dqkv.float().sum((0, 1))
    bound = 2e-2 * want.abs().max().item() + 1e-3
    torch.testing.assert_close(dbqkv.float(), want, atol=bound, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H", ATTN_SHAPES)
@pytest.mark.parametrize("entry", list(ATTENTION))
def test_f32_attention_kernel_matches_plain(cuda, entry, B, L, D, H):
    """``csrc/mha_f32.cu`` through each entry at f32 against the plain f32
    version: the forward within 5e-5, each gradient within 1e-4 of its
    largest magnitude (+1e-6); one launch each way under the entry's f32
    key; the no-grad forward and a second backward equal bit for bit."""
    kern, ref = ATTENTION[entry]
    leaves, do = _attention_inputs(entry, B, L, D, H, cuda, torch.float32)
    xs = [t.clone().requires_grad_() for t in leaves]
    _reset()
    out = _attention_call(entry, kern, xs, H)
    grads = torch.autograd.grad(out, xs, do, retain_graph=True)
    torch.cuda.synchronize()
    assert _launched() == {f"{entry}_fwd_f32": 1, f"{entry}_bwd_f32": 1}
    assert all(torch.equal(a, b) for a, b in
               zip(grads, torch.autograd.grad(out, xs, do, retain_graph=True)))
    with torch.no_grad():
        assert torch.equal(_attention_call(entry, kern, leaves, H), out)
    out_r = _attention_call(entry, ref, xs, H)
    grads_r = torch.autograd.grad(out_r, xs, do)
    assert out.dtype == torch.float32 and out.shape == out_r.shape
    torch.testing.assert_close(out, out_r, atol=5e-5, rtol=0)
    for a, b in zip(grads, grads_r):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item() + 1e-6, rtol=0)


# (B, L, d, H) at the f32 core's tile edges: L around its 16-row strips and
# 32-column tiles, head dims that are not a multiple of 4 (no 16-byte loads,
# each column count a lane holds), and B * H not a multiple of the heads a
# block takes at short L
F32_ATTN_EDGES = [(2, L, d, 3) for L in (31, 32, 63, 64, 65) for d in (8, 16, 24, 32)]
F32_ATTN_EDGES += [(2, 19, d, 2) for d in (1, 5, 13, 18, 30)] + [(7, 16, 8, 1), (5, 37, 24, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,H", F32_ATTN_EDGES)
@pytest.mark.parametrize("entry", ["mha_packed", "mha_pallas"])
def test_f32_attention_tile_edges(cuda, entry, B, L, d, H):
    """``csrc/mha_f32.cu`` at the edges of its tiles, through a pre-scaled
    and the post-scaled entry, against the plain f32 version; two calls give
    the same bits."""
    kern, ref = ATTENTION[entry]
    leaves, do = _attention_inputs(entry, B, L, H * d, H, cuda, torch.float32)
    xs = [t.clone().requires_grad_() for t in leaves]
    runs = []
    for _ in range(2):
        out = _attention_call(entry, kern, xs, H)
        runs.append((out, torch.autograd.grad(out, xs, do)))
    (out, grads), (out2, grads2) = runs
    assert torch.equal(out, out2) and all(map(torch.equal, grads, grads2))
    out_r = _attention_call(entry, ref, xs, H)
    _f32_close(out, grads, out_r, torch.autograd.grad(out_r, xs, do))


@pytest.mark.cuda
@pytest.mark.parametrize("L,d", [(50, 40), (100, 64), (9, 100)])
@pytest.mark.parametrize("post", [False, True], ids=["pre", "post"])
def test_f32_attention_core_beyond_32(cuda, L, d, post):
    """Head dims above 32 (the f32 branch's core takes them; the entries
    refuse them): the C entries on (B, H, L, d) tensors, the output and its
    gradients in column chunks of 32, against the plain f32 version; two
    calls give the same bits."""
    lib = _build.load()
    assert lib.ssrl_attn_f32_fits(L, d, 1)
    B, H = 3, 2
    g = torch.Generator().manual_seed(L + d)
    q, k, v, do = (torch.randn(B, H, L, d, generator=g).to(cuda) for _ in range(4))
    strides = (H * L * d, L * d, d)
    st = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / d**0.5
    outs = []
    for _ in range(2):
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        _build.check(lib.ssrl_mha_f32_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          *strides, *strides, B, H, L, d, scale, int(post), st),
                     "mha_f32_fwd")
        _build.check(lib.ssrl_mha_f32_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *strides, *strides, B, H, L, d, scale, int(post), st), "mha_f32_bwd")
        outs.append((o, dq, dk, dv))
    torch.cuda.synchronize()
    assert all(map(torch.equal, *outs))
    want_o = core.plain_fwd(q, k, v, post)
    _f32_close(outs[0][0], outs[0][1:], want_o, core.plain_bwd_f32(q, k, v, do, post))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ATTENTION))
def test_attention_rejects_float32(cuda, entry):
    """The entries take bf16 and f32 on the card (the f32 ones above);
    float16 they refuse."""
    leaves, _ = _attention_inputs(entry, 2, 17, 48, 4, cuda, torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        _attention_call(entry, ATTENTION[entry][0], leaves, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ATTENTION))
def test_attention_refuses_shapes_beyond_the_fit(cuda, entry):
    leaves, _ = _attention_inputs(entry, 2, 257, 64, 2, cuda)  # d=32, L > 256
    with pytest.raises(ValueError, match="beyond the kernel's fit"):
        _attention_call(entry, ATTENTION[entry][0], leaves, 2)


@pytest.mark.cuda
def test_fit_matches_the_library(cuda):
    """``attention_core.fits`` is the bf16 kernel's fit, and the f32 kernel
    (forward and backward) takes every shape within it."""
    lib = _build.load()
    for d in (1, 8, 12, 16, 17, 24, 32, 33):
        for L in (1, 16, 37, 145, 160, 161, 176, 177, 200, 256, 257, 300, 400):
            assert bool(lib.ssrl_mha_fits(L, d)) == core.fits(L, d), (L, d)
            if core.fits(L, d):
                assert lib.ssrl_attn_f32_fits(L, d, 1), (L, d)


# ---------------------------------------------------------------------------
# the fused patch embed
# ---------------------------------------------------------------------------

# (B, N, Pc, D, K): the flagship at K=37 (MAE), K=45 (JEPA context) and the
# full sequence (JEPA target); a ragged small geometry
EMBED_SHAPES = [(768, 144, 192, 144, 37), (768, 144, 192, 144, 45),
                (768, 144, 192, 144, None), (3, 20, 48, 40, 7), (3, 20, 48, 40, None)]


def _embed_inputs(B, N, Pc, D, K, device, dup=False):
    g = torch.Generator().manual_seed(B + N + D + (K or 0))
    patches = (torch.rand(B, N, Pc, generator=g) * 2 - 1).to(torch.bfloat16)
    params = [torch.randn(D, Pc, generator=g) * Pc**-0.5, 0.02 * torch.randn(D, generator=g),
              0.02 * torch.randn(1, 1, D, generator=g),
              0.02 * torch.randn(1, N + 1, D, generator=g)]
    idx = None
    if K is not None:
        if dup:
            idx = torch.randint(0, N + 1, (B, K), generator=g)
        else:
            perm = torch.argsort(torch.rand(B, N, generator=g), dim=-1)[:, :K - 1] + 1
            idx = torch.cat([torch.zeros(B, 1, dtype=torch.long), perm], dim=1)
        idx = idx.to(device)
    dy = torch.randn(B, N + 1 if K is None else K, D, generator=g).to(torch.bfloat16)
    return patches.to(device), [p.to(device) for p in params], idx, dy.to(device)


def _embed_run(fn, patches, params, idx, dy):
    leaves = [patches.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    out = fn(*leaves, idx)
    return out.detach(), torch.autograd.grad(out, leaves, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,Pc,D,K,dup", [(*s, False) for s in EMBED_SHAPES]
                         + [(3, 20, 48, 40, 30, True)])
def test_embed_kernel_matches_plain(cuda, B, N, Pc, D, K, dup):
    """Forward and all five backward outputs (dpatches, dW, db, dcls, dpos),
    one launch of each kernel; with repeated indices the kernel sums their
    gradients as the plain version does."""
    patches, params, idx, dy = _embed_inputs(B, N, Pc, D, K, cuda, dup)
    before = dict(ef.LAUNCHES)
    out_k, grads_k = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    assert {k: v - before[k] for k, v in ef.LAUNCHES.items() if v != before[k]} == {
        "patch_embed_fwd": 1, "patch_embed_bwd": 1}
    out_r, grads_r = _embed_run(ef.fused_patch_embed_ref, patches, params, idx, dy)
    with torch.no_grad():
        out_ng = ef.fused_patch_embed(patches, *params, idx)
    torch.cuda.synchronize()
    assert torch.equal(out_ng, out_k)
    assert out_k.dtype == torch.bfloat16 and out_k.shape == out_r.shape
    torch.testing.assert_close(out_k.float(), out_r.float(), atol=6e-2, rtol=0)
    for a, b in zip(grads_k, grads_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        bound = 2e-2 * b.float().abs().max().item() + 1e-3
        torch.testing.assert_close(a.float(), b.float(), atol=bound, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,dup", [(7, False), (7, True), (None, False)],
                         ids=["k7", "k7-repeats", "full"])
def test_f32_embed_kernel_matches_plain(cuda, K, dup):
    """``csrc/patch_embed_f32.cu`` at (2, 20, 48, 40) against the plain
    version at f32: the forward and all five backward outputs; repeated
    indices sum their gradients; one launch each way under the f32 keys and
    no other kernel; the no-grad forward and a second call equal bit for
    bit."""
    patches, params, idx, dy = _embed_inputs(2, 20, 48, 40, K, cuda, dup)
    patches, dy = patches.float(), dy.float()
    _reset()
    out_k, grads_k = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    torch.cuda.synchronize()
    assert _launched() == {"patch_embed_fwd_f32": 1, "patch_embed_bwd_f32": 1}
    out_2, grads_2 = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    assert torch.equal(out_2, out_k) and all(map(torch.equal, grads_2, grads_k))
    with torch.no_grad():
        assert torch.equal(ef.fused_patch_embed(patches, *params, idx), out_k)
    out_r, grads_r = _embed_run(ef.fused_patch_embed_ref, patches, params, idx, dy)
    _f32_close(out_k, grads_k, out_r, grads_r)


# (B, N, Pc, D, index): K=1, K=L with an index (every token, permuted),
# repeated indices, and widths that take the forward's 8 row groups (D >
# 144), the dW product's two column tiles (D/8 x Pc/8 > 512 threads) and the
# token sums in device memory (an [L][D] accumulator beyond shared memory)
F32_EMBED_EDGES = [(3, 20, 48, 40, "k1"), (3, 20, 48, 40, "kL"), (3, 20, 48, 40, "repeats"),
                   (2, 63, 64, 160, "k7"), (2, 40, 256, 256, "k7"), (2, 255, 64, 256, "repeats")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,Pc,D,kind", F32_EMBED_EDGES)
def test_f32_embed_edges(cuda, B, N, Pc, D, kind):
    """``csrc/patch_embed_f32.cu`` at the edges of its index forms and tiles
    against the plain f32 version, dpatches included; two calls give the same
    bits."""
    g = torch.Generator().manual_seed(B + N + D)
    L = N + 1
    idx = {"k1": lambda: torch.randint(0, L, (B, 1), generator=g),
           "kL": lambda: torch.argsort(torch.rand(B, L, generator=g), dim=-1),
           "repeats": lambda: torch.randint(0, L, (B, 30), generator=g),
           "k7": lambda: torch.randint(0, L, (B, 7), generator=g)}[kind]().to(cuda)
    patches = torch.rand(B, N, Pc, generator=g).to(cuda) * 2 - 1
    params = [(torch.randn(D, Pc, generator=g) * Pc**-0.5).to(cuda),
              (0.02 * torch.randn(D, generator=g)).to(cuda),
              (0.02 * torch.randn(1, 1, D, generator=g)).to(cuda),
              (0.02 * torch.randn(1, L, D, generator=g)).to(cuda)]
    dy = torch.randn(B, idx.shape[1], D, generator=g).to(cuda)
    out_k, grads_k = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    out_2, grads_2 = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    assert torch.equal(out_2, out_k) and all(map(torch.equal, grads_2, grads_k))
    out_r, grads_r = _embed_run(ef.fused_patch_embed_ref, patches, params, idx, dy)
    _f32_close(out_k, grads_k, out_r, grads_r)


@pytest.mark.cuda
def test_f32_embed_index_out_of_range(cuda):
    """At f32 too an index outside [0, L) gives a NaN row and no gradient."""
    B, N, Pc, D, K = 4, 20, 48, 40, 8
    patches, params, idx, dy = _embed_inputs(B, N, Pc, D, K, cuda)
    patches, dy = patches.float(), dy.float()
    bad = idx.clone()
    bad[:, 3] = N + 1
    bad[0, 5] = -1
    keep = [k for k in range(K) if k not in (3, 5)]
    out_k, grads_k = _embed_run(ef.fused_patch_embed, patches, params, bad, dy)
    assert torch.isnan(out_k[:, 3]).all() and torch.isnan(out_k[0, 5]).all()
    dy_live = dy.clone()
    dy_live[:, 3] = 0
    dy_live[0, 5] = 0
    out_r, grads_r = _embed_run(ef.fused_patch_embed_ref, patches, params, idx, dy_live)
    _f32_close(out_k[:, keep], grads_k, out_r[:, keep], grads_r)


@pytest.mark.cuda
def test_embed_index_out_of_range(cuda):
    """An index outside [0, L) gives a NaN row and no gradient: the other
    rows and every gradient are those of the index without it."""
    B, N, Pc, D, K = 4, 20, 48, 40, 8
    patches, params, idx, dy = _embed_inputs(B, N, Pc, D, K, cuda)
    bad = idx.clone()
    bad[:, 3] = N + 1
    bad[0, 5] = -1
    keep = [k for k in range(K) if k not in (3, 5)]
    out_k, grads_k = _embed_run(ef.fused_patch_embed, patches, params, bad, dy)
    assert torch.isnan(out_k[:, 3].float()).all() and torch.isnan(out_k[0, 5].float()).all()
    live = [k for k in range(K) if k != 3]
    assert not torch.isnan(out_k[1:, live].float()).any()
    dy_live = dy.clone()
    dy_live[:, 3] = 0
    dy_live[0, 5] = 0
    out_r, grads_r = _embed_run(ef.fused_patch_embed_ref, patches, params, idx, dy_live)
    torch.testing.assert_close(out_k[:, keep].float(), out_r[:, keep].float(), atol=6e-2, rtol=0)
    for a, b in zip(grads_k, grads_r):
        bound = 2e-2 * b.float().abs().max().item() + 1e-3
        torch.testing.assert_close(a.float(), b.float(), atol=bound, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [37, None], ids=["k37", "full"])
def test_embed_kernel_is_deterministic(cuda, K):
    """Two calls on the same inputs give the same bits, forward and every
    gradient, with an index and on the full sequence without one."""
    patches, params, idx, dy = _embed_inputs(768, 144, 192, 144, K, cuda)
    out, grads = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    out2, grads2 = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.cuda
def test_embed_skips_dpatches_when_not_asked(cuda):
    """Patches without grad (the main path's): no dpatches, and the other
    gradients are the same bits as with it."""
    patches, params, idx, dy = _embed_inputs(768, 144, 192, 144, 45, cuda)
    leaves = [p.clone().requires_grad_() for p in params]
    out = ef.fused_patch_embed(patches, *leaves, idx)
    grads = torch.autograd.grad(out, leaves, dy)
    _, with_dp = _embed_run(ef.fused_patch_embed, patches, params, idx, dy)
    for a, b in zip(grads, with_dp[1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_embed_refuses_what_it_does_not_take(cuda):
    patches, params, idx, _ = _embed_inputs(3, 20, 48, 40, 7, cuda)
    with pytest.raises(TypeError):
        ef.fused_patch_embed(patches.half(), *params, idx)
    with pytest.raises(ValueError):
        ef.fused_patch_embed(patches, *params, idx.int())
    bad, bparams, _, _ = _embed_inputs(3, 20, 44, 40, None, cuda)  # Pc % 8 != 0
    with pytest.raises(ValueError, match="multiples of 8"):
        ef.fused_patch_embed(bad, *bparams, None)
    long, lparams, _, _ = _embed_inputs(1, 300, 48, 40, None, cuda)  # L > 256
    with pytest.raises(ValueError, match="L <="):
        ef.fused_patch_embed(long, *lparams, None)


# ---------------------------------------------------------------------------
# the classifier step: which kernels each freeze policy launches
# ---------------------------------------------------------------------------

CLS_MODEL = {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
             "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4}}
CLS_TRAIN = {"learning_rate": 1e-3, "warmup_epochs": 1, "total_epochs": 10}
# policy -> (freeze_encoder, unfreeze_last_layers, launches of one step on
# 2 blocks): frozen blocks whose input needs no gradient take the no-grad
# attention forward and launch no backward
CLS_POLICIES = {
    "full": (False, None, {"attn_branch_fwd": 2, "attn_branch_bwd": 2, "mlp_branch_fwd": 2,
                           "mlp_branch_bwd": 2}),
    "probe": (True, None, {"attn_branch_fwd_nograd": 2, "mlp_branch_fwd": 2}),
    "unfreeze1": (False, 1, {"attn_branch_fwd": 1, "attn_branch_fwd_nograd": 1,
                             "attn_branch_bwd": 1, "mlp_branch_fwd": 2, "mlp_branch_bwd": 1}),
}


def _launched():
    counts = {**bf.LAUNCHES, **bc.LAUNCHES, **core.LAUNCHES, **ef.LAUNCHES}
    return {k: v for k, v in counts.items() if v}


def _reset():
    for m in (bf, bc, core, ef):
        m.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", list(CLS_POLICIES))
def test_classifier_step_launches(cuda, policy):
    """One bf16 classifier step per freeze policy launches exactly its
    branch kernels; trainable params move, frozen ones keep their bits; the
    eval step launches the no-grad forwards only."""
    freeze, unfreeze, want = CLS_POLICIES[policy]
    task = ClassifierTask(CLS_MODEL, CLS_TRAIN, device="cuda")
    task.set_freeze_policy(freeze_encoder=freeze, unfreeze_last_layers=unfreeze)
    state = task.init_state(0)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (8, 96, 96, 3), generator=g, dtype=torch.uint8),
             "label": torch.randint(0, 10, (8,), generator=g), "weight": torch.ones(8)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    _reset()
    state, sums = task.train_step(state, batch, 0)
    torch.cuda.synchronize()
    assert _launched() == want
    assert math.isfinite(float(sums["loss_sum"]))
    trainable = set(task.tx.trainable(state.params))
    for k, v in state.params.items():
        assert torch.equal(v, before[k]) != (k in trainable), k
    _reset()
    task.eval_step(state, batch, None)
    torch.cuda.synchronize()
    assert _launched() == {"attn_branch_fwd_nograd": 2, "mlp_branch_fwd": 2}


@pytest.mark.cuda
def test_init_state_twice_on_the_card(cuda):
    """A second ``init_state`` of a task on the card makes the same seeded
    state again: the weights are made on the CPU each time, then moved."""
    task = ClassifierTask(CLS_MODEL, CLS_TRAIN, device="cuda")
    first = {k: v.detach().clone() for k, v in task.init_state(0).params.items()}
    again = task.init_state(0).params
    assert set(again) == set(first)
    assert all(v.is_cuda and torch.equal(v, first[k]) for k, v in again.items())


# ---------------------------------------------------------------------------
# the bench's fused steps: the train step as a CUDA-graph replay
# ---------------------------------------------------------------------------

FUSED_MODEL = {**CLS_MODEL, "decoder": {"decoder_embed_dim": 48, "decoder_depth": 1,
                                        "decoder_num_heads": 4}}
FUSED_PRE = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "total_epochs": 10,
             "warmup_epochs": 1, "batch_size": 8, "base_learning_rate": 1e-3}
FUSED_JEPA = {**FUSED_PRE, "predictor_embed_dim": 48, "predictor_depth": 1,
              "predictor_num_heads": 4}


# case -> (task kind, attn_impl, freeze policy of CLS_POLICIES or None)
F32_STEP_CASES = {"mae-auto": ("mae", "auto", None), "mae-packed": ("mae", "packed", None),
                  "mae-pallas": ("mae", "pallas", None), "jepa": ("jepa", "auto", None),
                  "cls-full": ("cls", "auto", "full"), "cls-probe": ("cls", "auto", "probe"),
                  "cls-unfreeze1": ("cls", "auto", "unfreeze1")}


def _step_task(case, device, dtype):
    kind, impl, policy = F32_STEP_CASES[case]
    if kind == "mae":
        return MAETask(FUSED_MODEL, FUSED_PRE, dtype=dtype, device=device, attn_impl=impl)
    if kind == "jepa":
        return JEPATask(FUSED_MODEL, FUSED_JEPA, dtype=dtype, device=device, attn_impl=impl)
    task = ClassifierTask(CLS_MODEL, CLS_TRAIN, dtype=dtype, device=device, attn_impl=impl)
    freeze, unfreeze, _ = CLS_POLICIES[policy]
    task.set_freeze_policy(freeze_encoder=freeze, unfreeze_last_layers=unfreeze)
    return task


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(F32_STEP_CASES))
def test_f32_step_matches_the_cpu(cuda, case):
    """One f32 step's gradients on the card at a toy geometry, TF32 off:
    exactly the kernels of the bf16 step of the same task and route, each
    under its ``_f32`` key; the loss within rtol 1e-5 of the CPU step's from
    the same weights (and EMA target) and draws, and each trainable
    gradient within 1e-4 of the CPU tensor's largest magnitude (+1e-6)."""
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (8, 96, 96, 3), generator=g, dtype=torch.uint8),
             "label": torch.randint(0, 10, (8,), generator=g), "weight": torch.ones(8)}
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    bf16 = _step_task(case, "cuda", torch.bfloat16)
    bs = bf16.init_state(0)
    _reset()
    bf16.gradients(bs, gbatch, bf16.epoch_context(0))
    want = {f"{k}_f32": v for k, v in _launched().items()}
    gpu, cpu = (_step_task(case, dev, torch.float32) for dev in ("cuda", "cpu"))
    gs, cs = gpu.init_state(0), cpu.init_state(0)
    cpu.model.load_state_dict(gpu.model.state_dict())
    if gs.extra is not None:
        cs.extra = {k: v.cpu().clone() for k, v in gs.extra.items()}
    ctx = gpu.epoch_context(0)
    draws = gpu.draw(gs.generator, 8, ctx)
    _reset()
    names, grads, sums = gpu.gradients(gs, gbatch, ctx, draws)
    torch.cuda.synchronize()
    assert _launched() == want
    cdraws = tuple(None if d is None else d.cpu() for d in draws)
    names_c, grads_c, sums_c = cpu.gradients(cs, batch, ctx, cdraws)
    assert names == names_c and _launched() == want
    assert float(sums["loss_sum"]) == pytest.approx(float(sums_c["loss_sum"]), rel=1e-5)
    for k, a, b in zip(names, grads, grads_c):
        assert a.dtype == torch.float32, k
        torch.testing.assert_close(a.cpu(), b, atol=1e-4 * b.abs().max().item() + 1e-6,
                                   rtol=0, msg=k)


def _fused_task(kind):
    if kind == "mae":
        return MAETask(FUSED_MODEL, FUSED_PRE, device="cuda")
    if kind == "mae_f32":
        return MAETask(FUSED_MODEL, FUSED_PRE, dtype=torch.float32, device="cuda")
    if kind == "jepa":
        return JEPATask(FUSED_MODEL, FUSED_JEPA, device="cuda")
    return ClassifierTask(CLS_MODEL, CLS_TRAIN, device="cuda")


def _fused_state_tensors(state):
    opt = state.opt_state
    return [*state.params.values(), *opt.mu, *opt.nu, opt.count, opt.learning_rate,
            *(state.extra or {}).values()]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mae", "jepa", "classifier", "mae_f32"])
def test_fused_steps_replay_the_eager_steps(cuda, kind):
    """``train_steps_fused(n=3)`` (one eager step, the capture, two replays)
    and a second call (three replays) equal six ``train_step``s from the
    same seed bit for bit: params, Adam moments, count, rate, JEPA's EMA,
    the generator's state and the last sums. Deterministic algorithms on
    both sides: the JEPA gather's backward adds overlapping target rows
    with atomics otherwise."""
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (8, 96, 96, 3), generator=g, dtype=torch.uint8),
             "label": torch.randint(0, 10, (8,), generator=g), "weight": torch.ones(8)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for fused in (False, True):
            task = _fused_task(kind)
            state = task.init_state(0)
            ctx = task.epoch_context(0)
            if fused:
                for _ in range(2):
                    state, sums = task.train_steps_fused(state, batch, 0, ctx, 3)
            else:
                for _ in range(6):
                    state, sums = task.train_step(state, batch, 0, ctx)
            torch.cuda.synchronize()
            assert state.step == 6 and int(state.opt_state.count) == 6
            runs.append((_fused_state_tensors(state), state.generator.get_state(), sums))
    finally:
        torch.use_deterministic_algorithms(was)
    (ta, ga, sa), (tb, gb, sb) = runs
    assert len(ta) == len(tb) and all(torch.equal(a, b) for a, b in zip(ta, tb))
    assert torch.equal(ga, gb)
    assert sa.keys() == sb.keys() and all(
        torch.equal(sa[k], sb[k]) if torch.is_tensor(sa[k]) else sa[k] == sb[k] for k in sa)


# The branches split over a model axis (``ops/block_fused.py``'s TP entries):
# each shard's partial kernels, the finish and the LN backward against their
# plain versions, at model_parallel 2 and 3 (attention widths 72, 48, 96, 64,
# 48, 32, 24; hidden slices 288, 192, 384, 256, 192, 128, 96; the encoder's
# proj at mp=2 has K=72, a K tail of the wgmma loop), bf16 and f32; and the
# shards finished together against the unsplit branch kernel.
TP_SHAPES = [(64, 37, 144, 6, 2), (64, 37, 144, 6, 3), (32, 145, 192, 6, 2),
             (32, 145, 192, 6, 3), (32, 145, 96, 6, 2), (32, 145, 96, 6, 3), (3, 17, 48, 4, 2)]


def _tp_operands(kind, params, mp, m):
    from ssrl_vit_mae_jepa_torch.parallel.mesh import ShardSpec, shard_index

    D, dev = params[0].shape[0], params[0].device
    if kind == "attn":
        rows = shard_index(ShardSpec(0, 3), 3 * D, mp, m).to(dev)
        cols = shard_index(ShardSpec(1), D, mp, m).to(dev)
        return (params[0], params[1], params[2][rows], params[3][rows], params[4][:, cols])
    fs = shard_index(ShardSpec(0), params[2].shape[0], mp, m).to(dev)
    return (params[0], params[1], params[2][fs], params[3][fs], params[4][:, fs])


def _within(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    return err <= rel * want.float().abs().max().item() + 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("B,L,D,H,mp", TP_SHAPES)
def test_tp_entries_match_plain(cuda, dtype, kind, B, L, D, H, mp):
    f32 = dtype == "f32"
    dt = torch.float32 if f32 else torch.bfloat16
    fwd_atol, bwd_rel = (5e-5, 1e-4) if f32 else (6e-2, 2e-2)
    x, dy, params = _inputs(kind, B, L, D, cuda)
    x, dy = x.to(dt), dy.to(dt)
    hl = H // mp
    s = dys = 0
    for m in range(mp):
        p = _tp_operands(kind, params, mp, m)
        if kind == "attn":
            part, a = bf.attn_branch_partial(x, p, hl)
            part_ns, none = bf.attn_branch_partial(x, p, hl, stash=False)
            assert none is None and torch.equal(part_ns, part)
            ref, _ = bf.attn_part_plain(x, p, hl)
            dy1, grads = bf.attn_branch_partial_bwd(x, p, a, dy, hl)
            dy1_r, grads_r = bf.attn_part_bwd_plain(x, p, a, dy, hl)
        else:
            part = bf.mlp_branch_partial(x, p)
            ref = bf.mlp_part_plain(x, p)
            dy1, grads = bf.mlp_branch_partial_bwd(x, p, dy)
            dy1_r, grads_r = bf.mlp_part_bwd_plain(x, p, dy)
        torch.cuda.synchronize()
        assert part.dtype == torch.float32 and part.shape == (B, L, D)
        assert (part - ref).abs().max().item() <= fwd_atol
        for name, k, r in zip(("dy", "dw_a", "db_a", "dw_b"), (dy1, *grads), (dy1_r, *grads_r)):
            assert k.shape == r.shape, name
            ok, err = _within(k, r, bwd_rel)
            assert ok, f"shard {m} {name}: {err}"
        s, dys = s + part, dys + dy1
    out = bf.branch_finish(x, s, params[5])
    assert torch.equal(out, bf.branch_finish_plain(x, s, params[5]))
    dx, dln = bf.branch_ln_bwd(x, params[0], dys, dy)
    dx_r, dln_r = bf.ln_bwd_plain(x, params[0], dys, dy)
    for name, k, r in zip(("dx", "d_ln_s", "d_ln_b", "d_bias"), (dx, *dln), (dx_r, *dln_r)):
        ok, err = _within(k, r, bwd_rel)
        assert ok, f"LN backward {name}: {err}"
    # the shards finished together are the unsplit branch, up to f32 order
    leaves = [x.clone().requires_grad_()] + [q.clone().requires_grad_() for q in params]
    whole = (bf.fused_attn_branch(*leaves, H) if kind == "attn"
             else bf.fused_mlp_branch(*leaves))
    assert (whole.float() - out.float()).abs().max().item() <= fwd_atol
    gw = torch.autograd.grad(whole, leaves, dy)
    for name, k, r in (("dx", dx, gw[0]), ("d_ln_s", dln[0], gw[1]), ("d_ln_b", dln[1], gw[2]),
                       ("d_bias", dln[2], gw[6])):
        ok, err = _within(k, r, bwd_rel)
        assert ok, f"whole {name}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_tp_entries_count_and_are_deterministic(cuda, dtype):
    """Each TP entry adds one to its own counter per launch, and two calls
    give the same bits."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, dy, params = _inputs("attn", 8, 37, 144, cuda)
    x, dy = x.to(dt), dy.to(dt)
    p = _tp_operands("attn", params, 2, 1)
    bf.reset_launch_counts()
    runs = [bf.attn_branch_partial(x, p, 3) for _ in range(2)]
    grads = [bf.attn_branch_partial_bwd(x, p, runs[0][1], dy, 3) for _ in range(2)]
    ln = [bf.branch_ln_bwd(x, params[0], grads[0][0], dy) for _ in range(2)]
    fin = [bf.branch_finish(x, runs[0][0], params[5]) for _ in range(2)]
    torch.cuda.synchronize()
    key = lambda k: bf.dtype_key(dt, k)  # noqa: E731
    assert {k: v for k, v in bf.LAUNCHES.items() if v} == {
        key("attn_branch_part_fwd"): 2, key("attn_branch_part_bwd"): 2,
        key("branch_ln_bwd"): 2, key("branch_finish"): 2}
    for pair in (runs, [g[1] for g in grads], [g[0] for g in grads], [r[0] for r in ln],
                 [r[1] for r in ln], fin):
        a, b = pair
        for u, v in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)


# the LN backward's variants: name -> (activation dtype, gy f32, dx in f32 too)
LN_VARIANTS = {"bf16": (torch.bfloat16, False, False), "bf16_gy32": (torch.bfloat16, True, False),
               "bf16_dx32": (torch.bfloat16, False, True),
               "bf16_gy32_dx32": (torch.bfloat16, True, True), "f32": (torch.float32, False, False)}


def _ln_inputs(M, D, variant, device):
    dt, gy32, _ = LN_VARIANTS[variant]
    g = torch.Generator().manual_seed(M + D)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = (2.0 * rn(M, D) + 0.5).to(dt)
    s = 1.0 + 0.1 * rn(D)
    dy, gy = rn(M, D), rn(M, D)
    gy = gy if gy32 or dt == torch.float32 else gy.to(dt)
    return x.to(device), s.to(device), dy.to(device), gy.to(device)


def _ln_call(variant):
    """(the kernel, its plain version) of a variant, each returning (dx,
    dx32 or None, (d ln_s, d ln_b, sum gy))."""
    dt, _, dx32 = LN_VARIANTS[variant]
    if dt == torch.float32:
        def kern(x, s, dy, gy):
            dx, sums = bf.branch_ln_bwd(x, s, dy, gy)
            return dx, None, sums

        def plain(x, s, dy, gy):
            dx, sums = bf.ln_bwd_plain(x, s, dy, gy)
            return dx, None, sums
        return kern, plain

    def plain(x, s, dy, gy):
        dx, d32, sums = bf.ln_bwd_full_plain(x, s, dy, gy)
        return dx, d32 if dx32 else None, sums
    return (lambda x, s, dy, gy: bf.ln_bwd(x, s, dy, gy, dx32=dx32)), plain


def _ln_outputs(out):
    dx, d32, sums = out
    return (dx,) + ((d32,) if d32 is not None else ()) + tuple(sums)


LN_DS, LN_MS = [48, 96, 144, 192, 256], [1, 17, 4097, 28416]


@pytest.mark.cuda
@pytest.mark.parametrize("M", LN_MS)
@pytest.mark.parametrize("D", LN_DS)
@pytest.mark.parametrize("variant", list(LN_VARIANTS))
def test_ln_bwd_matches_plain(cuda, variant, D, M):
    """The LN backward kernel (``csrc/common.cuh::ln_bwd``: the four bf16
    instantiations through ``ln_bwd``, f32 through ``branch_ln_bwd``)
    against its plain version: dx (and its f32 form) and the three column
    sums within test_tp_entries_match_plain's bounds (2e-2 of the largest
    magnitude in bf16, 1e-4 at f32); a second call gives the same bits."""
    dt = LN_VARIANTS[variant][0]
    rel = 1e-4 if dt == torch.float32 else 2e-2
    x, s, dy, gy = _ln_inputs(M, D, variant, cuda)
    kern, plain = _ln_call(variant)
    got, again = _ln_outputs(kern(x, s, dy, gy)), _ln_outputs(kern(x, s, dy, gy))
    want = _ln_outputs(plain(x, s, dy, gy))
    torch.cuda.synchronize()
    assert len(got) == len(want) == (5 if LN_VARIANTS[variant][2] else 4)
    names = ("dx",) + (("dx32",) if len(got) == 5 else ()) + ("d_ln_s", "d_ln_b", "sum_gy")
    for name, k, r, k2 in zip(names, got, want, again):
        assert k.dtype == r.dtype and k.shape == r.shape, name
        ok, err = _within(k, r, rel)
        assert ok, f"{name}: {err}"
        assert torch.equal(k, k2), f"{name}: a second call differs"


def ln_bwd_kernels_a_call():
    """Print, as JSON, the device kernels (memsets aside) of one call of each
    LN backward variant at each shape of test_ln_bwd_matches_plain, by the
    profiler's names (run by test_ln_bwd_launches_one_kernel)."""
    out = {}
    for variant in LN_VARIANTS:
        kern, _ = _ln_call(variant)
        for D in LN_DS:
            for M in LN_MS:
                x, s, dy, gy = _ln_inputs(M, D, variant, "cuda")
                for _ in range(6):  # a profiler session now and then records nothing
                    names = _kernel_names(lambda: kern(x, s, dy, gy))
                    if names:
                        break
                out[f"{variant}-{D}-{M}"] = {k: n for k, n in names.items()
                                             if not k.startswith("Memset")}
    print(json.dumps(out))


@pytest.mark.cuda
def test_ln_bwd_launches_one_kernel(cuda):
    """Each LN backward variant launches one device kernel a call (the
    memset of its done counters aside) at every shape of
    test_ln_bwd_matches_plain, counted by the profiler's names in a process
    of its own: in this file's process, after its CUDA-graph captures, the
    profiler records no device activity (on an H100)."""
    here = pathlib.Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, {str(here.parent)!r}]; "
            "import test_torch_cuda as t; t.ln_bwd_kernels_a_call()")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=here.parent)
    assert proc.returncode == 0, proc.stderr[-3000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(counts) == len(LN_VARIANTS) * len(LN_DS) * len(LN_MS)
    for case, kernels in counts.items():
        assert list(kernels.values()) == [1], (case, kernels)
        assert "ln_bwd_kernel" in next(iter(kernels)), (case, kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 100, 255])
def test_ln_bwd_takes_any_width(cuda, D):
    """A width that is not a multiple of 8 (element loads, the same kernel)
    and a tensor that is not 16-byte aligned give the plain version's
    results, at bf16 and f32."""
    for variant in ("bf16_gy32_dx32", "f32"):
        x, s, dy, gy = _ln_inputs(333, D, variant, cuda)
        kern, plain = _ln_call(variant)
        rel = 1e-4 if variant == "f32" else 2e-2
        for k, r in zip(_ln_outputs(kern(x, s, dy, gy)), _ln_outputs(plain(x, s, dy, gy))):
            assert _within(k, r, rel)[0]
    x, s, dy, gy = _ln_inputs(334, 96, "bf16", cuda)
    xo, dyo, gyo = x.view(-1)[96:].view(333, 96), dy.view(-1)[96:].view(333, 96), gy[1:]
    kern, plain = _ln_call("bf16")
    assert xo.data_ptr() % 16 == 0 and dyo.data_ptr() % 16 == 0
    xm = x.view(-1)[1:1 + 333 * 96].view(333, 96)  # 2-byte offset: element loads
    for xx in (xo, xm):
        for k, r in zip(_ln_outputs(kern(xx, s, dyo, gyo)), _ln_outputs(plain(xx, s, dyo, gyo))):
            assert _within(k, r, 2e-2)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bf16_gy32_dx32", "f32"])
def test_ln_bwd_graph_replay_is_eager(cuda, variant):
    """A CUDA-graph replay of the LN backward (its memset and kernel
    captured) gives the eager call's bits, replay after replay."""
    x, s, dy, gy = _ln_inputs(28416, 144, variant, cuda)
    kern, _ = _ln_call(variant)
    eager = _ln_outputs(kern(x, s, dy, gy))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern(x, s, dy, gy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kern(x, s, dy, gy)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(_ln_outputs(out), eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 144, 192, 256])
def test_branch_finish_is_plain(cuda, D):
    """The finish ``bf16(x + bf16(s + b))`` equals ``branch_finish_plain``
    bit for bit at ragged row counts."""
    g = torch.Generator().manual_seed(D)
    for M in (1, 17, 4097):
        x = torch.randn(M, D, generator=g).bfloat16().to(cuda)
        s = (3.0 * torch.randn(M, D, generator=g)).to(cuda)
        b = (0.1 * torch.randn(D, generator=g)).bfloat16().to(cuda)
        assert torch.equal(bf.branch_finish(x, s, b), bf.branch_finish_plain(x, s, b))


@pytest.mark.cuda
def test_reconstruct_batch_draws_its_masks_on_the_card(cuda, tmp_path, monkeypatch):
    """``reconstruct_batch`` with no masks given draws them on the card (as
    the walkthrough and the CLI call it) and equals the call given those
    masks from the CPU: the drawn CUDA masks are not converted through
    numpy."""
    from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config
    from ssrl_vit_mae_jepa_torch.ops.masking import num_masked_tokens, random_token_mask
    from ssrl_vit_mae_jepa_torch.scripts.evaluation import visualize_reconstruction as vrec
    from ssrl_vit_mae_jepa_torch.utils.interop import export_reference_weights

    monkeypatch.delenv("SSRL_TORCH_DEVICE", raising=False)
    cfg = {"model": {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
                     "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
                     "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1,
                                 "decoder_num_heads": 4}}}
    model = mae_from_config(cfg["model"], dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    ckpt = export_reference_weights(tmp_path / "vit-mae.pt", model.state_dict())
    images = torch.randint(0, 256, (4, 96, 96, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1)).numpy()
    got = vrec.reconstruct_batch(cfg, ckpt, images)
    L = model.sequence_length
    masks = random_token_mask(torch.Generator(cuda).manual_seed(vrec.MASK_SEED), 4, L,
                              num_masked_tokens(L, 0.75))
    want = vrec.reconstruct_batch(cfg, ckpt, images, masks=[m.cpu() for m in masks])
    assert math.isfinite(got["psnr"]) and got["mse"] > 0
    assert got["psnr"] == want["psnr"] and got["mse"] == want["mse"]
