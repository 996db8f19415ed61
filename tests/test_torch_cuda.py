"""The CUDA kernels against their plain PyTorch versions, on the card: the
branch GEMM alone (every layout and epilogue against ``gemm_ref``), the
two branch kernels, the whole-block kernel of ``csrc/fused_block.cu``, the
chained-block kernel of ``csrc/block_chain.cu``, the four attention entries
of ``csrc/mha.cu`` and the fused patch embed of ``csrc/patch_embed.cu``.

Marked ``cuda`` and skipped without a GPU. The file imports no JAX, so it
also runs where JAX is not installed; ``tests/conftest.py`` does import JAX,
so there run it without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

bf16 throughout. The forward is held to 6e-2 absolute (the bf16 forward
tolerance of ``tests/test_block_kernel.py``). In the backward both sides
round to bf16 at different points (the plain version's autograd rounds dW,
dP and dy1 to bf16, the kernels keep them in f32), so each of the seven
outputs is held to 2% of its largest magnitude: far below the O(1)
relative error of a layout or indexing fault. The attention entries, the
whole block and the chain are held to the same bounds against their
``*_ref`` versions, which round at the kernel's own points.
"""

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

# (B, L, D, H): the MAE encoder and decoder at B=768; the JEPA context
# encoder, predictor (D=96, d=16, F=384) and target encoder at B=768; a head
# dim of 12 with ragged L, and the longest sequence the attention backward
# takes at d=32
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
def test_cuda_rejects_float32(cuda):
    x, _, params = _inputs("mlp", 2, 5, 16, cuda)
    with pytest.raises(TypeError):
        bf.fused_mlp_branch(x.float(), *params)


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
        "block_fwd": 1, "block_bwd": 1}
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
    assert bc.LAUNCHES == {k: v + 1 for k, v in before.items()}
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
@pytest.mark.parametrize("kind", ["mono", "chain"])
def test_block_kernels_are_deterministic(cuda, kind):
    """Repeated calls on the same inputs give the same bits (no atomics:
    every sum is a fixed-order reduction)."""
    B, L, D, H = 768, 145, 192, 6
    x, dy, params = _stack_inputs(B, L, D, 2 if kind == "chain" else 1, cuda)
    fn = (lambda x, pl: bc.fused_block_chain(x, pl, H)) if kind == "chain" else _mono(H)
    first = _stack_run(fn, x, dy, params)
    for _ in range(2):
        out, grads = _stack_run(fn, x, dy, params)
        assert torch.equal(out, first[0])
        assert all(torch.equal(a, b) for a, b in zip(grads, first[1]))


@pytest.mark.cuda
def test_block_kernels_refuse_what_they_do_not_take(cuda):
    x, _, params = _stack_inputs(2, 17, 48, 2, cuda)
    with pytest.raises(TypeError):
        bf.fused_block(x.float(), params[0], 4)
    with pytest.raises(TypeError):
        bc.fused_block_chain(x.float(), params, 4)
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
        bf.gemm(a.float(), b.float(), "nt", "bias_bf16", bias=ex["bias"])
    with pytest.raises(ValueError, match="multiples of 8"):
        bf.gemm(a[:, :12].contiguous(), b[:, :12].contiguous(), "nt", "bias_bf16",
                bias=ex["bias"])
    with pytest.raises(ValueError, match="epilogues"):
        bf.gemm(a, b, "nt", "f32")


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
@pytest.mark.parametrize("entry", list(ATTENTION))
def test_attention_rejects_float32(cuda, entry):
    leaves, _ = _attention_inputs(entry, 2, 17, 48, 4, cuda, torch.float32)
    with pytest.raises(TypeError):
        _attention_call(entry, ATTENTION[entry][0], leaves, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ATTENTION))
def test_attention_refuses_shapes_beyond_the_fit(cuda, entry):
    leaves, _ = _attention_inputs(entry, 2, 257, 64, 2, cuda)  # d=32, L > 256
    with pytest.raises(ValueError, match="beyond the kernel's fit"):
        _attention_call(entry, ATTENTION[entry][0], leaves, 2)


@pytest.mark.cuda
def test_fit_matches_the_library(cuda):
    lib = _build.load()
    for d in (1, 8, 12, 16, 17, 24, 32, 33):
        for L in (1, 16, 37, 145, 160, 161, 176, 177, 200, 256, 257, 300, 400):
            assert bool(lib.ssrl_mha_fits(L, d)) == core.fits(L, d), (L, d)


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
    assert ef.LAUNCHES == {k: v + 1 for k, v in before.items()}
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
        ef.fused_patch_embed(patches.float(), *params, idx)
    with pytest.raises(ValueError):
        ef.fused_patch_embed(patches, *params, idx.int())
    bad, bparams, _, _ = _embed_inputs(3, 20, 44, 40, None, cuda)  # Pc % 8 != 0
    with pytest.raises(ValueError, match="multiples of 8"):
        ef.fused_patch_embed(bad, *bparams, None)
    long, lparams, _, _ = _embed_inputs(1, 300, 48, 40, None, cuda)  # L > 256
    with pytest.raises(ValueError, match="L <="):
        ef.fused_patch_embed(long, *lparams, None)
