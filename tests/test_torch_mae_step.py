"""The slice as a whole: one MAE pretraining step of the port against the
JAX ``MAETask`` step, at a toy geometry in f32 on the CPU.

Geometry: 96 px, patch 8, encoder 48/2/4, decoder 32/1/4, B=4. The JAX side
is ``MAETask(dtype=jnp.float32)`` with no mesh (off the TPU ``block_impl``
returns None, so this is the flax path); the port is built from the same
params through ``mae_params_from_jax``. JAX's draws are reproduced as
``Task._local_train_step`` makes them (``split(state.rng, 3)``, then
``draw_augment_params``, then ``random_token_mask``) and injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.training.optim import set_learning_rate
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_torch.utils.interop import mae_params_from_jax
from ssrl_vit_mae_jepa_tpu.ops.augment import apply_augment_patches, draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.optim import set_learning_rate as j_set_lr
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils.torch_interop import mae_params_to_state

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
B = 4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    jtask = JMAETask(CFG, PRE_CFG, dtype=jnp.float32)
    jstate = jtask.init_state(jax.random.PRNGKey(0))
    ctx = jtask.epoch_context(0)
    images = np.random.default_rng(0).integers(0, 256, (B, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(B, np.int32),
             "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, B)
    idx_keep, idx_mask = random_token_mask(task_rng, B, jtask.sequence_length, ctx)
    jimages = apply_augment_patches(u, flip, images, patch_size=8, out_size=96)

    def loss_fn(p):
        return jtask.loss_and_metric_sums(p, jimages, batch, task_rng, ctx)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    params0 = _np_tree(jstate.params)

    ttask = TMAETask(CFG, PRE_CFG, dtype=torch.float32, device="cpu")
    tstate = ttask.init_state(0)
    mae_params_from_jax(params0, ttask.model)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (u, flip, idx_keep, idx_mask))
    draws = draws[:2] + tuple(d.long() for d in draws[2:])
    tbatch = {"image": torch.from_numpy(images), "weight": torch.from_numpy(batch["weight"])}
    return dict(jtask=jtask, jstate=jstate, ctx=ctx, batch=batch, jloss=float(jloss),
                jgrads=_np_tree(jgrads), params0=params0, ttask=ttask, tstate=tstate,
                draws=draws, tbatch=tbatch)


def test_port_export_matches_the_jax_package(setup):
    """The port's own copy of ``mae_params_to_state`` gives the JAX
    package's export key for key and bit for bit."""
    mine = interop.mae_params_to_state(setup["params0"])
    want = mae_params_to_state(setup["params0"])
    assert list(mine) == list(want)
    for k, v in want.items():
        assert mine[k].dtype == v.dtype and mine[k].shape == v.shape, k
        assert np.array_equal(mine[k], v), k


def test_task_runs_on_the_card_unless_told_otherwise():
    assert TMAETask(CFG, PRE_CFG).device == torch.device("cuda")
    assert TMAETask(CFG, PRE_CFG, device="cpu").device == torch.device("cpu")


def _port_loss_and_grads(s):
    t, st = s["ttask"], s["tstate"]
    u, flip, keep, mask = s["draws"]
    images = t.preprocess_train(u, flip, s["tbatch"]["image"])
    loss, _ = t.loss_and_metric_sums(images, s["tbatch"], (keep, mask), s["ctx"])
    names = list(st.params)
    grads = torch.autograd.grad(loss, [st.params[n] for n in names])
    return loss.item(), dict(zip(names, grads))


def test_loss_and_every_gradient_match(setup):
    loss, grads = _port_loss_and_grads(setup)
    assert loss == pytest.approx(setup["jloss"], rel=1e-5)
    want = mae_params_to_state(setup["jgrads"])
    assert set(grads) == set(want) - {"encoder.mask_token"}
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def test_train_step_matches(setup):
    """A whole step (augment, mask, loss, grads, clip, AdamW) from the same
    state and draws: params within 2·lr of the JAX step's, since Adam's
    first step is ±lr per element and near-zero gradients may differ in
    sign."""
    s = setup
    jnew, jsums = s["jtask"].train_step(
        jax.tree.map(jnp.array, s["jstate"]), s["batch"], 0, s["ctx"]
    )
    want = mae_params_to_state(_np_tree(jnew.params))
    before = mae_params_to_state(s["params0"])
    ttask = TMAETask(CFG, PRE_CFG, dtype=torch.float32, device="cpu")
    tstate = ttask.init_state(0)
    mae_params_from_jax(s["params0"], ttask.model)
    tstate, tsums = ttask.train_step(tstate, s["tbatch"], 0, s["ctx"], draws=s["draws"])
    lr = tsums["lr"]
    assert lr == pytest.approx(float(jsums["lr"]), rel=1e-6)
    assert float(tsums["loss_sum"]) == pytest.approx(float(jsums["loss_sum"]), rel=1e-5)
    assert float(tsums["weight_sum"]) == float(jsums["weight_sum"])
    assert tstate.step == 1
    for name, p in tstate.params.items():
        moved = np.abs(want[name] - before[name]).max()
        assert moved > 0.5 * lr, name  # the JAX step did move this param
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2 * lr, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_optimizer_matches_optax(setup, scale):
    """The same gradients into both optimizers give the same params; the
    large scale forces the global-norm clip."""
    s = setup
    jtask = s["jtask"]
    grads = jax.tree.map(lambda g: g * scale, s["jgrads"])
    opt_state = jtask.tx.init(s["params0"])
    lr = 3e-3
    opt_state = j_set_lr(opt_state, lr)
    update = jax.jit(jtask.tx.update)
    for _ in range(2):
        updates, opt_state = update(grads, opt_state, s["params0"])
    want = mae_params_to_state(_np_tree(
        jax.tree.map(lambda p, u: p + u, s["params0"], updates)
    ))
    # JAX applied both updates to params0, so the port's second step must
    # also start from params0: step twice, restoring params in between
    ttask = TMAETask(CFG, PRE_CFG, dtype=torch.float32, device="cpu")
    tstate = ttask.init_state(0)
    mae_params_from_jax(s["params0"], ttask.model)
    tgrads = {k: torch.from_numpy(v) for k, v in mae_params_to_state(grads).items()
              if k in tstate.params}
    set_learning_rate(tstate.opt_state, lr)
    for _ in range(2):
        mae_params_from_jax(s["params0"], ttask.model)
        ttask.tx.update(tgrads, tstate.opt_state, tstate.params)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=0,
                                   err_msg=name)
