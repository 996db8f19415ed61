"""The chained-block slice: ``fused_block_chain``'s plain version against
the JAX Pallas kernel ``block_chain.fused_block_chain`` run in interpret
mode, and one ``MAETask`` and one ``JEPATask`` step under
``attn_impl="chain"`` against the JAX tasks. The CUDA kernel is held to the
plain version on the card by ``tests/test_torch_cuda.py``.

At D=48 < 128 the JAX package zero-pads the stack to 128 features and runs
the kernel with ``d_real`` (``models/vit.py:255-269`` there), a TPU layout
device; the port runs at the real D, so these cases also hold the port to
the padded route. Tolerances are those of ``tests/test_torch_block_mono.py``
(f32: 5e-5 forward, 3e-4 + 1e-6 relative gradients, accumulation order
only; bf16: 6e-2 forward per block, 0.15 + 1% gradients); the forward of a
bf16 stack is held to 6e-2 per block, since a rounding that flips in one
block carries into the next.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.models import vit as tvit
from ssrl_vit_mae_jepa_torch.ops import block_chain as tbc
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.utils.interop import (
    jepa_params_from_jax,
    jepa_params_to_state,
    vit_params_to_state,
)
from ssrl_vit_mae_jepa_tpu.ops import block_chain as jbc
from ssrl_vit_mae_jepa_tpu.ops import block_pallas as jbp
from ssrl_vit_mae_jepa_tpu.ops import jepa_masking as jm
from ssrl_vit_mae_jepa_tpu.ops.augment import draw_augment_params
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from tests.test_torch_block_mono import (
    DTYPES,
    _tree_np,
    assert_grads,
    assert_steps_match,
    block_params,
    flax_grads,
    mae_step_pair,
    torch_leaves,
)
from tests.test_torch_jepa import JEPA_CFG, MODEL

B, L, D, H, N = 2, 17, 48, 4, 2


def _jax_chain(x, params_list):
    """The JAX route for D < 128: pad to the 128-lane tile, chain with
    d_real, slice back."""
    pad = 128 - D
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, pad)))
    padded = [jbp.pad_attn_branch_params(*p[:6], pad) + jbp.pad_mlp_branch_params(*p[6:], pad)
              for p in params_list]
    return jbc.fused_block_chain(xp, padded, H, d_real=D)[..., :D]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chain_ref_matches_pallas_kernel(dtype):
    """Forward, the no-grad forward, dx and all 12·N weight gradients."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    x, g = (rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(2))
    ps = [block_params(D, seed=10 + k) for k in range(N)]

    def loss(x, ps):
        out = _jax_chain(x, ps)
        return jnp.sum(out.astype(jnp.float32) * g), out

    jps = [list(map(jnp.asarray, p)) for p in ps]
    with pltpu.force_tpu_interpret_mode():
        (_, j_out), (j_dx, j_dp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x, jdt), jps)
        j_nograd = _jax_chain(jnp.asarray(x, jdt), jps)  # the stash-free primal
    np.testing.assert_array_equal(np.asarray(j_nograd, np.float32), np.asarray(j_out, np.float32))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [torch_leaves(p) for p in ps]
    tbc.reset_launch_counts()
    out = tbc.fused_block_chain(xt, pt, H)
    flat = [t for p in pt for t in p]
    grads = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), [xt, *flat])
    with torch.no_grad():
        out_ng = tbc.fused_block_chain(xt, pt, H)
    assert not any(tbc.LAUNCHES.values())  # the CPU never launches
    assert torch.equal(out_ng, out.detach())
    j_grads = [j_dx] + [a for p in j_dp for a in p]
    assert_grads(out.detach().float().numpy(), flax_grads(grads), j_out, j_grads, dtype,
                 blocks=N)


def test_chain_forward_is_the_split_branches():
    """The chain's forward is the split branches' function bit for bit (z
    rounded), in bf16 and in f32."""
    rng = np.random.default_rng(9)
    ps = [[torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
           for a in block_params(D, seed=20 + k)] for k in range(3)]
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dt)
        y = x
        for p in ps:
            y = bf.mlp_branch_ref(bf.attn_branch_ref(y, *p[:6], H), *p[6:])
        assert torch.equal(tbc.chain_ref(x, ps, H), y)


@pytest.mark.parametrize("impl", ["chain", "auto"])
def test_stack_takes_the_chain_only_when_forced(monkeypatch, impl):
    """run_block_stack hands the whole stack to the chain under "chain" (and
    only then), with each block's tensors read from its modules, so
    torch.func.functional_call still substitutes them."""
    vit = tvit.VisionTransformer(embed_dim=48, depth=2, num_heads=4, dtype=torch.float32,
                                 attn_impl=impl)
    vit.init_weights(torch.Generator().manual_seed(0))
    calls = []

    def record(x, params_list, num_heads):
        calls.append(len(params_list))
        return tbc.fused_block_chain(x, params_list, num_heads)

    monkeypatch.setattr(tvit, "fused_block_chain", record)
    images = torch.rand(2, 96, 96, 3) * 2 - 1
    keep = torch.arange(17).expand(2, 17)
    other = {k: v + 0.01 for k, v in vit.state_dict().items()}
    with torch.no_grad():
        out = torch.func.functional_call(vit, other, (images, keep))
        vit.load_state_dict(other)
        want = vit(images, keep)
    assert calls == ([2, 2] if impl == "chain" else [])
    assert torch.equal(out, want)


def test_mae_step_matches_jax_chain():
    """MAETask under attn_impl="chain": both stacks (encoder and decoder,
    depth 2) run as chains on both sides, and the step agrees."""
    jnew, jsums, state, sums, params0, export = mae_step_pair("chain")
    assert_steps_match(jnew, jsums, state, sums, params0, export, ("loss_sum", "weight_sum"))


def test_jepa_step_matches_jax_chain():
    """JEPATask under attn_impl="chain" (predictor depth 2): the context
    encoder and predictor chain with grad, the EMA target encoder through
    the no-grad forward; the step, its sums and the EMA agree."""
    cfg = {**JEPA_CFG, "predictor_depth": 2}
    jtask = JJEPATask(MODEL, cfg, dtype=jnp.float32, attn_impl="chain")
    jstate = jtask.init_state(jax.random.PRNGKey(0))
    leaves, tdef = jax.tree.flatten(jstate.extra)
    noise = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    extra = [a + 0.02 * jax.random.normal(k, a.shape) for a, k in zip(leaves, noise)]
    jstate = jstate.replace(extra=jax.tree.unflatten(tdef, extra))
    params0 = _tree_np(jstate.params)
    task = TJEPATask(MODEL, cfg, dtype=torch.float32, device="cpu", attn_impl="chain")
    state = task.init_state(0)
    jepa_params_from_jax(params0, task.model)
    state.extra = {k: torch.from_numpy(v)
                   for k, v in vit_params_to_state(_tree_np(jstate.extra)).items()}
    images = np.random.default_rng(0).integers(0, 256, (4, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(4, np.int32),
             "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, 4)
    t_idx, c_idx = jm.sample_jepa_masks(
        task_rng, 4, jtask.grid_size, jtask.num_blocks, jtask.block_area,
        jtask.context_size, jtask.aspect_range, context_sampling=jtask.context_sampling,
        context_scale=jtask.context_scale)
    with pltpu.force_tpu_interpret_mode():
        jnew, jsums = jtask.train_step(jax.tree.map(jnp.array, jstate), batch, 1, None)
    draws = [torch.from_numpy(np.array(a)) for a in (u, flip, t_idx, c_idx)]
    draws = tuple(draws[:2] + [d.long() for d in draws[2:]])
    extra0 = {k: v.clone() for k, v in state.extra.items()}
    tbatch = {"image": torch.from_numpy(images), "weight": torch.from_numpy(batch["weight"])}
    state, sums = task.train_step(state, tbatch, 1, None, draws=draws)
    assert not any(tbc.LAUNCHES.values())
    assert_steps_match(jnew, jsums, state, sums, params0, jepa_params_to_state,
                       ("loss_sum", "weight_sum", "pred_std_sum", "target_std_sum",
                        "cos_sum", "ema_drift_sum"))
    m = task._momentum(state, 1)
    want = vit_params_to_state(_tree_np(jnew.extra))
    for k, v in state.extra.items():
        mine = extra0[k] * m + state.params["encoder." + k].detach() * (1 - m)
        torch.testing.assert_close(v, mine, atol=1e-7, rtol=0)
        np.testing.assert_allclose(v.numpy(), want[k], atol=2 * sums["lr"] * (1 - m) + 1e-6,
                                   rtol=0, err_msg=k)
