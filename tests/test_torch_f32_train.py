"""f32 training: the plain backwards the f32 branch kernels are held to, and
whole f32 training steps, against the JAX package on the CPU.

On the card, ``csrc/branch_f32.cu`` computes the split branches' f32
forward with its stash and their f32 backward, and ``csrc/mha_f32.cu`` the
four attention entries at f32; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` (phase 23) hold them there to ``attn_bwd_plain`` /
``mlp_bwd_plain`` and the attention entries' plain versions. Here those plain
backwards are held, fed the JAX forward's own stash ``a``, to the Pallas
kernels' backward (``block_pallas._ab_bwd`` / ``_mb_bwd``) in interpret mode,
with the f32 tolerance of ``tests/test_block_kernel.py`` (atol 3e-4, rtol
1e-6: the two sum in different orders, and the TPU kernels' GELU uses a
rational erf within 1.5e-7 of the exact one); the shapes add the JEPA
predictor's head dim 16.

The f32 step: ``MAETask(dtype=torch.float32)`` on the sub-layer routes
``packed`` and ``pallas`` takes a whole ``train_step`` (augment, mask, loss,
gradients, clip, AdamW) from the JAX task's converted weights and injected
draws, against the JAX ``MAETask(dtype=jnp.float32)`` step with the same
attention kernels in interpret mode. The other f32 steps are held
elsewhere: MAE on ``auto`` by ``tests/test_torch_mae_step.py``, JEPA by
``tests/test_torch_jepa.py``, the classifier under each freeze policy by
``tests/test_torch_classifier.py``, and the loss and gradients on packed
and pallas by ``tests/test_torch_attention.py``. The plain f32 attention
backward of the four entries is held to the Pallas kernels at f32 by
``tests/test_torch_attention.py::test_plain_matches_pallas_kernel``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch.ops import attention_core
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils.interop import mae_params_from_jax
from ssrl_vit_mae_jepa_tpu.ops import block_pallas as jbp
from ssrl_vit_mae_jepa_tpu.ops.augment import draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils.torch_interop import mae_params_to_state

# (B, L, D, H): head dims 12, 24 (the MAE encoder at L=37) and 16 (the JEPA
# predictor's, D=96, at the JEPA context length)
SHAPES = [(3, 17, 48, 4), (2, 37, 144, 6), (2, 45, 96, 6)]
ATOL, RTOL = 3e-4, 1e-6  # tests/test_block_kernel.py:109-110, f32
NAMES = ["dx", "dln_s", "dln_b", "dWa", "dba", "dWb", "dbb"]


def _branch_params(kind, D, seed):
    """Flax-layout params (ln_s, ln_b, Wa (in, out), ba, Wb (in, out), bb)."""
    rng = np.random.default_rng(seed)
    n = 3 * D if kind == "attn" else 4 * D
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    wb_in = D if kind == "attn" else n
    return (1.0 + 0.1 * f(D), 0.1 * f(D), f(D, n) * D**-0.5, 0.1 * f(n),
            f(wb_in, D) * wb_in**-0.5, 0.1 * f(D))


@pytest.mark.parametrize("B,L,D,H", SHAPES)
@pytest.mark.parametrize("kind", ["attn", "mlp"])
def test_plain_branch_backward_matches_the_pallas_backward(kind, B, L, D, H):
    """``attn_bwd_plain`` / ``mlp_bwd_plain`` at f32 from the JAX forward's
    residuals against ``_ab_bwd`` / ``_mb_bwd``: the input gradient (with
    the residual's) and the six parameter gradients."""
    rng = np.random.default_rng(B * L + D)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    p = _branch_params(kind, D, seed=D)
    jargs = (jnp.asarray(x), *map(jnp.asarray, p))
    with pltpu.force_tpu_interpret_mode():
        if kind == "attn":
            _, res = jbp._ab_fwd(*jargs, H)
            want = jbp._ab_bwd(H, None, res, jnp.asarray(g))
        else:
            _, res = jbp._mb_fwd(*jargs)
            want = jbp._mb_bwd(None, res, jnp.asarray(g))
    want = [np.asarray(t, np.float32) for t in want]

    s, b, wa, ba, wb, bb = (torch.from_numpy(t) for t in p)
    tp = (s, b, wa.T.contiguous(), ba, wb.T.contiguous(), bb)  # torch Linear layout
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    if kind == "attn":
        a = torch.from_numpy(np.array(res[2], np.float32)).reshape(B, L, D)
        dx, grads = bf.attn_bwd_plain(xt, tp, a, gt, H)
    else:
        dx, grads = bf.mlp_bwd_plain(xt, tp, gt, round_z=True)
    got = [dx] + list(grads)
    assert all(t.dtype == torch.float32 for t in got)
    got = [t.numpy() for t in got]
    got[3], got[5] = got[3].T, got[5].T  # back to flax (in, out)
    for name, a_, b_ in zip(NAMES, got, want):
        np.testing.assert_allclose(a_, b_.reshape(a_.shape), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{kind} {name}")


CFG = {
    "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
    "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
    "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
}
# warmup 1 and a large base LR, so that one step moves every param by ~lr
PRE_CFG = {
    "mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
    "total_epochs": 800, "warmup_epochs": 1, "batch_size": 4,
    "base_learning_rate": 1e-2, "weight_decay": 0.05,
}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_f32_mae_train_step_matches_jax(impl):
    """One f32 ``train_step`` of the port on a sub-layer route against the
    JAX step from the same weights and draws: the converted weights are f32
    and equal to the JAX params bit for bit (the flax -> torch maps at f32);
    the loss within rtol 1e-5; every param after the AdamW update within
    2·lr of the JAX step's (Adam's first step is ±lr per element, and
    near-zero gradients may differ in sign); no kernel launches on the CPU."""
    n = 4
    jtask = JMAETask(CFG, PRE_CFG, dtype=jnp.float32, attn_impl=impl)
    jstate = jtask.init_state(jax.random.PRNGKey(0))
    ctx = jtask.epoch_context(0)
    images = np.random.default_rng(0).integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(n, np.int32),
             "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}
    # the draws of the JAX step (Task._local_train_step's split of its rng)
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, n)
    keep, mask = random_token_mask(task_rng, n, jtask.sequence_length, ctx)
    params0 = _np_tree(jstate.params)
    with pltpu.force_tpu_interpret_mode():
        jnew, jsums = jtask.train_step(jstate, batch, 0, ctx)
    want = mae_params_to_state(_np_tree(jnew.params))
    before = mae_params_to_state(params0)

    task = TMAETask(CFG, PRE_CFG, dtype=torch.float32, device="cpu", attn_impl=impl)
    state = task.init_state(0)
    mae_params_from_jax(params0, task.model)
    for name, t in state.params.items():
        assert t.dtype == torch.float32, name
        assert np.array_equal(t.detach().numpy(), before[name]), name
    draws = tuple(torch.from_numpy(np.array(a)) for a in (u, flip, keep, mask))
    draws = draws[:2] + tuple(d.long() for d in draws[2:])
    tbatch = {"image": torch.from_numpy(images), "weight": torch.from_numpy(batch["weight"])}
    attention_core.reset_launch_counts()
    state, sums = task.train_step(state, tbatch, 0, ctx, draws=draws)
    assert not any(attention_core.LAUNCHES.values())
    lr = sums["lr"]
    assert lr == pytest.approx(float(jsums["lr"]), rel=1e-6)
    assert float(sums["loss_sum"]) == pytest.approx(float(jsums["loss_sum"]), rel=1e-5)
    for name, p in state.params.items():
        assert p.dtype == torch.float32, name
        assert np.abs(want[name] - before[name]).max() > 0.5 * lr, name  # JAX moved it
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2 * lr, rtol=0,
                                   err_msg=name)
