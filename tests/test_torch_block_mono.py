"""The whole-block slice: ``fused_block``'s plain version against the JAX
Pallas kernel ``block_pallas.fused_block`` run in interpret mode (as
``tests/test_block_kernel.py`` runs it), and one ``MAETask`` step under
``attn_impl="block"`` against the JAX ``MAETask``. The CUDA kernel is held
to the plain version on the card by ``tests/test_torch_cuda.py``.

Tolerances: f32 differs by accumulation order only, so the forward is held
to 5e-5 and every gradient to 3e-4 absolute plus 1e-6 relative, those of
``tests/test_block_kernel.py``. In bf16 both sides round at the same points,
but a product that lands on a rounding boundary may round the other way
(the TPU kernel's erf is a rational approximation, its sums run in another
order), and that flip carries through the backward: the forward is held to
6e-2 (one bf16 ulp at |x| < 8, the JAX test's bound) and the gradients to
0.15 absolute plus 1% relative, tighter than the JAX test's 0.5 and 5%.

The whole step runs at a toy geometry (96 px, patch 8, encoder 48/2/4,
decoder 32/2/4, B=4) in f32; ``mae_step_pair`` is shared with
``tests/test_torch_chain.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.ops import block_chain as tbc
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils.interop import mae_params_from_jax, mae_params_to_state
from ssrl_vit_mae_jepa_tpu.ops import block_pallas as jbp
from ssrl_vit_mae_jepa_tpu.ops.augment import draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from tests.test_torch_mae_step import PRE_CFG

B, L, D, H = 2, 17, 48, 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_ATOL = {"float32": 5e-5, "bfloat16": 6e-2}
BWD_TOL = {"float32": (3e-4, 1e-6), "bfloat16": (1.5e-1, 1e-2)}
# decoder depth 2: the chain needs a stack of at least two blocks
CFG = {
    "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
    "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
    "decoder": {"decoder_embed_dim": 32, "decoder_depth": 2, "decoder_num_heads": 4},
}
STEP_B = 4
# Adam's first moment after one step is 0.1 x the clipped gradient: the
# gradient bound of tests/test_attention.py:256 (5e-5) carried through it
MU_ATOL = 5e-6


def block_params(D, seed):
    """One block's 12 params in flax layouts (kernels (in, out)), numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    F_ = 4 * D
    return [1.0 + 0.1 * f(D), 0.1 * f(D), f(D, 3 * D) * D**-0.5, 0.1 * f(3 * D),
            f(D, D) * D**-0.5, 0.1 * f(D), 1.0 + 0.1 * f(D), 0.1 * f(D),
            f(D, F_) * D**-0.5, 0.1 * f(F_), f(F_, D) * F_**-0.5, 0.1 * f(D)]


def torch_leaves(p):
    """Flax-layout numpy params → torch-layout leaves that require grad."""
    return [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)).requires_grad_()
            for a in p]


def flax_grads(grads):
    """Torch-layout gradients → numpy f32 in flax layouts."""
    return [g.float().numpy().T if g.dim() == 2 else g.float().numpy() for g in grads]


def assert_grads(t_out, t_grads, j_out, j_grads, dtype, blocks=1):
    """Forward within FWD_ATOL per block of a bf16 stack (``blocks``), then
    every gradient within BWD_TOL."""
    atol = FWD_ATOL[dtype] * (blocks if dtype == "bfloat16" else 1)
    np.testing.assert_allclose(t_out, np.asarray(j_out, np.float32), atol=atol, rtol=0,
                               err_msg="forward")
    assert len(t_grads) == len(j_grads)
    atol, rtol = BWD_TOL[dtype]
    for i, (a, b) in enumerate(zip(t_grads, j_grads)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=atol, rtol=rtol,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_ref_matches_pallas_kernel(dtype):
    """Forward, dx and all 12 weight gradients of the whole block."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x, g = (rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(2))
    p = block_params(D, seed=1)

    def loss(x, *p):
        out = jbp.fused_block(x, *p, H)
        return jnp.sum(out.astype(jnp.float32) * g), out

    with pltpu.force_tpu_interpret_mode():
        (_, j_out), j_grads = jax.value_and_grad(loss, argnums=tuple(range(13)), has_aux=True)(
            jnp.asarray(x, jdt), *map(jnp.asarray, p))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = torch_leaves(p)
    bf.reset_launch_counts()
    out = bf.fused_block(xt, pt, H)
    grads = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), [xt, *pt])
    assert not any(bf.LAUNCHES.values())  # the CPU never launches
    assert [t.dtype for t in grads] == [tdt] + [torch.float32] * 12
    assert_grads(out.detach().float().numpy(), flax_grads(grads), j_out, j_grads, dtype)


def test_block_ref_rounds_where_the_kernel_does():
    """bf16: the whole block keeps z in f32 where the split branches round
    it, so the two differ; in f32 they are one function. On the CPU the
    wrapper is the plain version, with and without grad."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32))
    p = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
         for a in block_params(D, seed=2)]

    def split(x):
        return bf.mlp_branch_ref(bf.attn_branch_ref(x, *p[:6], H), *p[6:])

    torch.testing.assert_close(bf.block_ref(x, p, H), split(x), atol=1e-5, rtol=0)
    xb = x.to(torch.bfloat16)
    assert not torch.equal(bf.block_ref(xb, p, H), split(xb))
    with torch.no_grad():
        assert torch.equal(bf.fused_block(xb, p, H), bf.block_ref(xb, p, H))


def test_supported_is_the_kernels_fit():
    assert bf.supported(768, 37, 144, 6, 576) and bf.supported(768, 145, 192, 6, 768)
    assert bf.supported(768, 145, 96, 6, 384) and bf.supported(2, 17, 48, 4, 192)
    assert not bf.supported(2, 161, 64, 2, 256)   # L beyond the attention fit at d=32
    assert not bf.supported(2, 17, 256, 4, 1024)  # head dim 64
    assert not bf.supported(2, 17, 100, 4, 400)   # D not a multiple of 8
    assert not bf.supported(2, 17, 48, 5, 192)    # D % H
    assert not bf.supported(2, 17, 264, 8, 1056)  # D > 256


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def mae_step_pair(impl):
    """One MAETask step on both sides, f32, from the same params and draws,
    the JAX Pallas kernels in interpret mode: (JAX state after, JAX sums,
    port state after, port sums, params before, export function)."""
    jtask = JMAETask(CFG, PRE_CFG, dtype=jnp.float32, attn_impl=impl)
    jstate = jtask.init_state(jax.random.PRNGKey(0))
    ctx = jtask.epoch_context(0)
    images = np.random.default_rng(0).integers(0, 256, (STEP_B, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(STEP_B, np.int32),
             "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, STEP_B)
    idx_keep, idx_mask = random_token_mask(task_rng, STEP_B, jtask.sequence_length, ctx)
    params0 = _tree_np(jstate.params)
    with pltpu.force_tpu_interpret_mode():
        jnew, jsums = jtask.train_step(jax.tree.map(jnp.array, jstate), batch, 0, ctx)
    task = TMAETask(CFG, PRE_CFG, dtype=torch.float32, device="cpu", attn_impl=impl)
    state = task.init_state(0)
    mae_params_from_jax(params0, task.model)
    draws = [torch.from_numpy(np.array(a)) for a in (u, flip, idx_keep, idx_mask)]
    draws = draws[:2] + [d.long() for d in draws[2:]]
    tbatch = {"image": torch.from_numpy(images), "weight": torch.from_numpy(batch["weight"])}
    bf.reset_launch_counts()
    tbc.reset_launch_counts()
    state, sums = task.train_step(state, tbatch, 0, ctx, draws=tuple(draws))
    assert not any(bf.LAUNCHES.values()) and not any(tbc.LAUNCHES.values())
    return jnew, jsums, state, sums, params0, mae_params_to_state


def assert_steps_match(jnew, jsums, state, sums, params0, export, sum_keys):
    """Sums rel 1e-5; Adam's first moments (0.1 x the clipped gradient)
    within MU_ATOL, so the gradients are held, not only their signs; the
    params within 2·lr of the JAX step's (Adam's first step is ±lr per
    element), every one of them moved."""
    lr = sums["lr"]
    assert lr == pytest.approx(float(jsums["lr"]), rel=1e-6)
    for k in sum_keys:
        assert float(sums[k]) == pytest.approx(float(jsums[k]), rel=1e-5), k
    names = list(state.params)
    want_mu = export(_tree_np(optax.tree_utils.tree_get(jnew.opt_state, "mu")))
    for name, mu in zip(names, state.opt_state.mu):
        np.testing.assert_allclose(mu.numpy(), want_mu[name], atol=MU_ATOL, rtol=0,
                                   err_msg=f"first moment {name}")
    want, before = export(_tree_np(jnew.params)), export(params0)
    for name in names:
        assert np.abs(want[name] - before[name]).max() > 0.5 * lr, name
        np.testing.assert_allclose(state.params[name].detach().numpy(), want[name],
                                   atol=2 * lr, rtol=0, err_msg=name)


def test_mae_step_matches_jax_block():
    """The slice as a whole: MAETask under attn_impl="block" takes the
    whole-block route in every block and steps as the JAX MAETask does."""
    jnew, jsums, state, sums, params0, export = mae_step_pair("block")
    assert_steps_match(jnew, jsums, state, sums, params0, export,
                       ("loss_sum", "weight_sum"))


def test_blocks_take_the_whole_block_route():
    task = TMAETask(CFG, PRE_CFG, dtype=torch.float32, device="cpu", attn_impl="block")
    blocks = [*task.model.encoder.vit.blocks, *task.model.decoder.decoder_blocks]
    assert len(blocks) == 4 and all(b.route == "mono" for b in blocks)
