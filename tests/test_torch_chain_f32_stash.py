"""The f32 chain's stash (``ops/block_chain.py::stash_floats``, the layout of
``csrc/block_chain_f32.cu``) and the f32 chain on the CPU against the JAX
Pallas kernel ``block_chain.fused_block_chain`` in interpret mode.

The f32 training forward keeps, after the bf16 chain's 3N − 1 slots of
(B, L, D), each block's LN1 output, qkv, LN2 output, z and h, so that its
backward runs neither the qkv nor the fc1 product again; the bf16 chain
keeps its 3N − 1 slots. On the card ``tests/test_torch_cuda.py`` holds the
kernel's backward to the split f32 pair bit for bit; here the CPU route
(``chain_ref``) stays held to the JAX chain at the f32 tolerances of
``tests/test_torch_chain.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.ops import block_chain as tbc
from tests.test_torch_block_mono import assert_grads, block_params, flax_grads, torch_leaves
from tests.test_torch_chain import B, D, H, L, _jax_chain


@pytest.mark.parametrize("N,B,L,D,F", [(2, 2, 17, 48, 192), (4, 768, 37, 144, 576),
                                       (2, 768, 145, 192, 768)])
def test_bf16_stash_is_the_slots(N, B, L, D, F):
    """bf16: a_k, x_mid_k and x_in_k (k ≥ 1), 3N − 1 tensors of (B, L, D)."""
    assert tbc.stash_floats(N, B, L, D, F, torch.bfloat16) == (3 * N - 1) * B * L * D


# (N, B, L, D, F) -> the f32 stash in floats, counted by hand from the slot
# order of csrc/block_chain_f32.cu: 3N - 1 slots of M x D (M = B L), then per
# block y1 (M x D), qkv (M x 3D), y2 (M x D), z and h (M x F each)
F32_STASH = {
    (2, 2, 17, 48, 192): 5 * 34 * 48 + 2 * (34 * 48 + 34 * 144 + 34 * 48 + 2 * 34 * 192),
    (3, 3, 5, 16, 64): 8 * 15 * 16 + 3 * (15 * 16 + 15 * 48 + 15 * 16 + 2 * 15 * 64),
}


@pytest.mark.parametrize("geo", list(F32_STASH))
def test_f32_stash_layout(geo):
    N, B, L, D, F = geo
    assert tbc.stash_floats(N, B, L, D, F, torch.float32) == F32_STASH[geo]
    M = B * L
    assert F32_STASH[geo] - tbc.stash_floats(N, B, L, D, F, torch.bfloat16) == N * M * (
        5 * D + 2 * F)


def test_f32_chain_matches_jax_chain():
    """The f32 chain on the CPU (2 blocks, D=48): forward, dx and all 24
    weight gradients against the JAX chain in interpret mode."""
    N = 2
    rng = np.random.default_rng(20)
    x, g = (rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(2))
    ps = [block_params(D, seed=30 + k) for k in range(N)]

    def loss(x, ps):
        out = _jax_chain(x, ps)
        return jnp.sum(out * g), out

    with pltpu.force_tpu_interpret_mode():
        (_, j_out), (j_dx, j_dp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), [list(map(jnp.asarray, p)) for p in ps])
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch_leaves(p) for p in ps]
    out = tbc.fused_block_chain(xt, pt, H)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [xt, *(t for p in pt for t in p)])
    assert_grads(out.detach().numpy(), flax_grads(grads), j_out,
                 [j_dx] + [a for p in j_dp for a in p], "float32", blocks=N)
