"""Transformer-branch parity.

The plain versions ``attn_branch_ref``/``mlp_branch_ref`` against the
JAX Pallas kernels ``fused_attn_branch``/``fused_mlp_branch`` run in
interpret mode (as ``tests/test_block_kernel.py`` runs them), forward and
every gradient, and the port's ``Block`` against the flax
``Block(attn_impl="xla")`` on its branch route and against the flax
``Block`` with the same attn_impl on its sub-layer route. The CUDA kernels are held to these plain
versions on the card by ``tests/test_torch_cuda.py``. Tolerances are those of
``tests/test_block_kernel.py``: f32 differs by accumulation order only; in
bf16 the two sides round activations at different points of their
backward (autograd here, a hand-written backward there), so sum-reduced
bias gradients over B·L rows differ by accumulated bf16 quantization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.models.vit import Block as TBlock
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_tpu.models.vit import Block as JBlock
from ssrl_vit_mae_jepa_tpu.ops import block_pallas as jbp

SHAPES = [(3, 17, 48, 4), (2, 37, 144, 6)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_ATOL = {"float32": 5e-5, "bfloat16": 6e-2}
BWD_TOL = {"float32": (3e-4, 1e-6), "bfloat16": (5e-1, 5e-2)}


def _branch_params(kind, D, seed):
    """Flax-layout params (ln_s, ln_b, Wa (in, out), ba, Wb (in, out), bb)."""
    rng = np.random.default_rng(seed)
    n = 3 * D if kind == "attn" else 4 * D
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    wb_in = D if kind == "attn" else n
    return (1.0 + 0.1 * f(D), 0.1 * f(D), f(D, n) * D**-0.5, 0.1 * f(n),
            f(wb_in, D) * wb_in**-0.5, 0.1 * f(D))


def _to_torch_layout(p):
    s, b, wa, ba, wb, bb = p
    return (s, b, wa.T.copy(), ba, wb.T.copy(), bb)


def _jax_branch(kind, x, g, p, H, jdt):
    def loss(x, *p):
        args = (x.astype(jdt), *p)
        out = (jbp.fused_attn_branch(*args, H) if kind == "attn"
               else jbp.fused_mlp_branch(*args))
        return jnp.sum(out.astype(jnp.float32) * g), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), grads = jax.value_and_grad(
            loss, argnums=tuple(range(7)), has_aux=True
        )(jnp.asarray(x, jdt), *map(jnp.asarray, p))
    return np.asarray(out, np.float32), [np.asarray(gr, np.float32) for gr in grads]


def _torch_branch(kind, x, g, p, H, tdt):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in _to_torch_layout(p)]
    out = (bf.attn_branch_ref(xt, *pt, H) if kind == "attn"
           else bf.mlp_branch_ref(xt, *pt))
    grads = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), [xt, *pt])
    grads = [gr.float().numpy() for gr in grads]
    grads[3], grads[5] = grads[3].T, grads[5].T  # back to flax (in, out)
    return out.detach().float().numpy(), grads


@pytest.mark.parametrize("kind", ["attn", "mlp"])
@pytest.mark.parametrize("B,L,D,H", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_branch_matches_pallas_kernel(kind, B, L, D, H, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(B * L + D)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    p = _branch_params(kind, D, seed=D)
    j_out, j_grads = _jax_branch(kind, x, g, p, H, jdt)
    t_out, t_grads = _torch_branch(kind, x, g, p, H, tdt)
    np.testing.assert_allclose(t_out, j_out, atol=FWD_ATOL[dtype], rtol=0)
    atol, rtol = BWD_TOL[dtype]
    names = ["dx", "dln_s", "dln_b", "dWa", "dba", "dWb", "dbb"]
    for name, a, b in zip(names, t_grads, j_grads):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f"{kind} {name}")


def _flax_block_to_torch(params, blk: TBlock):
    p = params["params"]
    a, m = blk.attn, blk.mlp
    pairs = [
        (blk.norm1.weight, p["norm1"]["scale"]), (blk.norm1.bias, p["norm1"]["bias"]),
        (a.qkv.weight, p["attn"]["qkv"]["kernel"].T), (a.qkv.bias, p["attn"]["qkv"]["bias"]),
        (a.proj.weight, p["attn"]["proj"]["kernel"].T), (a.proj.bias, p["attn"]["proj"]["bias"]),
        (blk.norm2.weight, p["norm2"]["scale"]), (blk.norm2.bias, p["norm2"]["bias"]),
        (m.fc1.weight, p["mlp"]["fc1"]["kernel"].T), (m.fc1.bias, p["mlp"]["fc1"]["bias"]),
        (m.fc2.weight, p["mlp"]["fc2"]["kernel"].T), (m.fc2.bias, p["mlp"]["fc2"]["bias"]),
    ]
    with torch.no_grad():
        for t, v in pairs:
            t.copy_(torch.from_numpy(np.array(v, np.float32)))


@pytest.mark.parametrize("B,L,D,H", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_matches_flax_block(B, L, D, H, dtype):
    """The port's Block on CPU (plain branches) ≡ flax Block(attn_impl="xla"),
    output and input gradient."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    jblk = JBlock(D, H, dtype=jdt, attn_impl="xla")
    params = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x, jdt))

    def loss(x):
        out = jblk.apply(params, x)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, j_out), j_dx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x, jdt))
    tblk = TBlock(D, H, dtype=tdt)
    _flax_block_to_torch(params, tblk)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    bf.reset_launch_counts()
    out = tblk(xt)
    (t_dx,) = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), [xt])
    assert all(v == 0 for v in bf.LAUNCHES.values())  # CPU never launches
    np.testing.assert_allclose(
        out.detach().float().numpy(), np.asarray(j_out, np.float32),
        atol=FWD_ATOL[dtype], rtol=0,
    )
    atol, rtol = BWD_TOL[dtype]
    np.testing.assert_allclose(
        t_dx.float().numpy(), np.asarray(j_dx, np.float32), atol=atol, rtol=rtol
    )


@pytest.mark.parametrize("impl", ["xla", "stacked", "packed", "pallas"])
@pytest.mark.parametrize("B,L,D,H", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sublayer_block_matches_flax_block(impl, B, L, D, H, dtype):
    """The sub-layer route (LN, Attention, LN, Mlp) ≡ the flax Block with the
    same attn_impl (its Pallas attention in interpret mode), output and
    input gradient; on the CPU "stacked" is the plain path on both sides."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    jblk = JBlock(D, H, dtype=jdt, attn_impl=impl)

    def loss(x):
        out = jblk.apply(params, x)
        return jnp.sum(out.astype(jnp.float32) * g), out

    with pltpu.force_tpu_interpret_mode():
        params = jblk.init(jax.random.PRNGKey(2), jnp.asarray(x, jdt))
        (_, j_out), j_dx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x, jdt))
    tblk = TBlock(D, H, dtype=tdt, attn_impl=impl)
    assert tblk.route is None
    _flax_block_to_torch(params, tblk)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = tblk(xt)
    (t_dx,) = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), [xt])
    np.testing.assert_allclose(
        out.detach().float().numpy(), np.asarray(j_out, np.float32),
        atol=FWD_ATOL[dtype], rtol=0,
    )
    atol, rtol = BWD_TOL[dtype]
    np.testing.assert_allclose(
        t_dx.float().numpy(), np.asarray(j_dx, np.float32), atol=atol, rtol=rtol
    )


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 2, 8, device="meta")
    w = [torch.zeros(8)] * 6
    with pytest.raises(ValueError):
        bf.fused_mlp_branch(x, *w)
