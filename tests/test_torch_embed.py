"""The port's fused patch embed (``ops/embed_fused.py``) on the CPU: its plain
version against the JAX Pallas kernel in interpret mode, and the ViT's
``SSRL_FUSED_EMBED`` dispatch against the unfused chain.

Shapes are ``tests/test_embed_pallas.py``'s (D >= 128 is the JAX kernel's
own limit); inputs are made with numpy from a seed. The JAX kernel takes
``w`` as (Pc, D), the port in torch's Linear layout (D, Pc). Tolerances are
that file's: f32 forward atol 2e-5, backward atol 5e-4 per output, bf16
forward atol 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import jax
from ssrl_vit_mae_jepa_torch.models.vit import VisionTransformer
from ssrl_vit_mae_jepa_torch.ops import embed_fused
from ssrl_vit_mae_jepa_torch.ops.embed_fused import (
    fused_patch_embed,
    fused_patch_embed_ref,
    use_fused_embed,
)
from ssrl_vit_mae_jepa_tpu.ops.embed_pallas import fused_patch_embed as jax_fused_patch_embed

# (B, N, Pc, D, K): the flagship encoder geometry at B=8 (interpret mode is
# slow), with K=37 (MAE) and the full form; a small geometry with B=16
SHAPES = [(8, 144, 192, 144, 37), (8, 144, 192, 144, None),
          (16, 16, 128, 128, 5), (16, 16, 128, 128, None)]


def _operands(B, N, Pc, D, K, seed=0, dup=False):
    """numpy (patches, w (Pc, D), b, cls, pos, idx); idx holds CLS at 0 and
    K-1 distinct patch tokens per row, or with ``dup`` repeats."""
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((B, N, Pc)).astype(np.float32)
    w = (0.05 * rng.standard_normal((Pc, D))).astype(np.float32)
    b = (0.05 * rng.standard_normal(D)).astype(np.float32)
    cls = (0.02 * rng.standard_normal((1, 1, D))).astype(np.float32)
    pos = (0.02 * rng.standard_normal((1, N + 1, D))).astype(np.float32)
    idx = None
    if K is not None:
        rows = []
        for _ in range(B):
            if dup:
                kept = rng.integers(0, N + 1, K)  # repeats, CLS anywhere
            else:
                kept = np.concatenate([[0], np.sort(rng.permutation(N)[: K - 1] + 1)])
            rows.append(kept)
        idx = np.stack(rows).astype(np.int32)
    return patches, w, b, cls, pos, idx


def _jax(ops, dtype=jnp.float32):
    patches, w, b, cls, pos, idx = ops
    return (jnp.asarray(patches, dtype), jnp.asarray(w), jnp.asarray(b), jnp.asarray(cls),
            jnp.asarray(pos), None if idx is None else jnp.asarray(idx))


def _torch(ops, dtype=torch.float32):
    patches, w, b, cls, pos, idx = ops
    return (torch.from_numpy(patches).to(dtype), torch.from_numpy(np.ascontiguousarray(w.T)),
            torch.from_numpy(b), torch.from_numpy(cls), torch.from_numpy(pos),
            None if idx is None else torch.from_numpy(idx).long())


@pytest.mark.parametrize("B,N,Pc,D,K", SHAPES)
def test_forward_matches_the_jax_kernel(B, N, Pc, D, K):
    ops = _operands(B, N, Pc, D, K)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_patch_embed(*_jax(ops)))
    got = fused_patch_embed_ref(*_torch(ops))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def _jax_grads(ops, g):
    patches, w, b, cls, pos, idx = _jax(ops)

    def f(patches, w, b, cls, pos):
        return jnp.sum(jax_fused_patch_embed(patches, w, b, cls, pos, idx) * g)

    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(a) for a in jax.grad(f, argnums=(0, 1, 2, 3, 4))(
            patches, w, b, cls, pos)]


def _port_grads(ops, g, fn=fused_patch_embed_ref):
    leaves = [t.requires_grad_() for t in _torch(ops)[:5]]
    out = fn(*leaves, _torch(ops)[5])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    dp, dw, db, dcls, dpos = (t.numpy() for t in grads)
    return [dp, dw.T, db, dcls, dpos]  # dw back to the JAX layout


@pytest.mark.parametrize("B,N,Pc,D,K,dup", [
    (*SHAPES[0], False), (*SHAPES[3], False), (*SHAPES[2], True)])
def test_backward_matches_the_jax_kernel(B, N, Pc, D, K, dup):
    """Every output of the backward, including a case with repeated
    indices: both sides sum the gradient of a repeated token."""
    ops = _operands(B, N, Pc, D, K, seed=1, dup=dup)
    g = np.random.default_rng(11).standard_normal(
        (B, K if K is not None else N + 1, D)).astype(np.float32)
    want = _jax_grads(ops, g)
    got = _port_grads(ops, g)
    for name, a, c in zip(("dpatches", "dw", "db", "dcls", "dpos"), want, got):
        assert a.shape == c.shape, name
        np.testing.assert_allclose(c, a, atol=5e-4, rtol=0, err_msg=name)


def _split_order_bwd(patches, w, idx, g):
    """The f32 kernel's backward order (``csrc/patch_embed_f32.cu``) in
    torch ops: dW = dyᵀ X over the kept rows alone (X a row's patch row,
    zero for CLS), in the kernel's row ranges summed in range order;
    d(cls_pos) as token sums of dy rows, rows in order within a range and
    ranges in order; db the sum of d(cls_pos) over tokens 1..L-1. Returns
    (dw (D, Pc), db, dcp (L, D))."""
    B, N, Pc = patches.shape
    D, K = g.shape[-1], g.shape[1]
    L, rows = N + 1, B * g.shape[1]
    tok = (idx if idx is not None else torch.arange(L).expand(B, L)).reshape(-1)
    dy = g.reshape(-1, D)
    img = torch.arange(B).repeat_interleave(K)
    has_patch = (tok >= 1) & (tok < L)
    X = torch.zeros(rows, Pc)
    X[has_patch] = patches[img[has_patch], tok[has_patch] - 1]
    splits = min(-(-rows // 64), 128)
    chunk = -(-(-(-rows // splits)) // 16) * 16
    dw, dcp = torch.zeros(D, Pc), torch.zeros(L, D)
    for r0 in range(0, rows, chunk):
        part = torch.zeros(L, D)
        for r in range(r0, min(r0 + chunk, rows)):
            if 0 <= tok[r] < L:
                part[tok[r]] += dy[r]
        dw = dw + dy[r0:r0 + chunk].T @ X[r0:r0 + chunk]
        dcp = dcp + part
    return dw, dcp[1:].sum(0), dcp


@pytest.mark.parametrize("B,N,Pc,D,K,dup", [
    (*SHAPES[0], False), (*SHAPES[2], True), (*SHAPES[3], False)], ids=["k37", "dup", "full"])
def test_f32_backward_order_matches_the_jax_kernel(B, N, Pc, D, K, dup):
    """The f32 kernel's order of work for dW, d(cls_pos) and db against the
    JAX kernel's VJP in interpret mode, at f32 with an index, with repeated
    indices and without an index: each output within 5e-4 (this file's
    backward tolerance; f32 sums in another order move them by ~1e-6)."""
    ops = _operands(B, N, Pc, D, K, seed=2, dup=dup)
    g = np.random.default_rng(12).standard_normal(
        (B, K if K is not None else N + 1, D)).astype(np.float32)
    _, want_dw, want_db, want_dcls, want_dpos = _jax_grads(ops, g)
    patches, w, _, _, _, idx = _torch(ops)
    dw, db, dcp = _split_order_bwd(patches, w, idx, torch.from_numpy(g))
    for name, got, want in (("dw", dw.T, want_dw), ("db", db, want_db),
                            ("dcls", dcp[0], want_dcls.reshape(D)),
                            ("dpos", dcp, want_dpos.reshape(N + 1, D))):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0, err_msg=name)


def test_bf16_forward_close():
    ops = _operands(8, 144, 192, 144, 37)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_patch_embed(*_jax(ops, jnp.bfloat16)), np.float32)
    got = fused_patch_embed_ref(*_torch(ops, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=0)


def test_plain_version_sums_repeated_indices():
    """A token gathered twice gets both rows' gradients: d(cls_pos) and dW
    against a numpy scatter-add."""
    B, N, Pc, D = 2, 6, 8, 8
    ops = _operands(B, N, Pc, D, None, seed=3)
    idx = np.array([[0, 3, 3, 5], [2, 2, 2, 0]])
    ops = ops[:5] + (idx,)
    g = np.random.default_rng(4).standard_normal((B, 4, D)).astype(np.float32)
    dp, dw, db, dcls, dpos = _port_grads(ops, g)
    dfull = np.zeros((B, N + 1, D), np.float32)
    for bi in range(B):
        for k, t in enumerate(idx[bi]):
            dfull[bi, t] += g[bi, k]
    np.testing.assert_allclose(dpos[0], dfull.sum(0), atol=1e-6)
    np.testing.assert_allclose(dcls[0, 0], dfull[:, 0].sum(0), atol=1e-6)
    np.testing.assert_allclose(db, dfull[:, 1:].sum((0, 1)), atol=1e-6)
    np.testing.assert_allclose(dw, np.einsum("bnc,bnd->cd", ops[0], dfull[:, 1:]), atol=1e-5)
    np.testing.assert_allclose(dp, dfull[:, 1:] @ ops[1].T, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    ops = _torch(_operands(4, 16, 128, 128, 5))
    embed_fused.reset_launch_counts()
    assert torch.equal(fused_patch_embed(*ops), fused_patch_embed_ref(*ops))
    assert set(embed_fused.LAUNCHES) == {"patch_embed_fwd", "patch_embed_bwd",
                                         "patch_embed_fwd_f32", "patch_embed_bwd_f32"}
    assert not any(embed_fused.LAUNCHES.values())


@pytest.mark.parametrize("flag,on", [(None, False), ("0", False), ("1", True),
                                     ("force", True), ("yes", False)])
def test_switch_is_read_per_call(monkeypatch, flag, on):
    if flag is None:
        monkeypatch.delenv("SSRL_FUSED_EMBED", raising=False)
    else:
        monkeypatch.setenv("SSRL_FUSED_EMBED", flag)
    assert use_fused_embed() is on


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, 7e-2)])
def test_vit_dispatch_force(monkeypatch, dtype, atol):
    """The whole ViT with the fused prologue equals the unfused chain, on
    the masked-encode and the full-sequence path, forward and gradients. In
    bf16 the fused path folds cls + pos in f32 where the chain rounds each
    first: a one-ulp input difference that the block can double (the JAX
    test's 7e-2)."""
    model = VisionTransformer(img_size=32, patch_size=8, embed_dim=32, depth=1,
                              num_heads=4, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
    idx = torch.from_numpy(np.stack([np.concatenate([[0], np.sort(rng.permutation(16)[:6] + 1)])
                                     for _ in range(4)]))

    def run(*args):
        out = model(images, *args)
        params = [p for p in model.parameters()]
        return out.float(), torch.autograd.grad(out.float().sum(), params)

    for args in ((idx,), ()):
        monkeypatch.delenv("SSRL_FUSED_EMBED", raising=False)
        ref, ref_g = run(*args)
        monkeypatch.setenv("SSRL_FUSED_EMBED", "force")
        out, out_g = run(*args)
        torch.testing.assert_close(out, ref, atol=atol, rtol=0)
        if dtype == torch.float32:
            for a, b in zip(out_g, ref_g):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
