"""Whole fits of the port against the JAX package: ten MAE and ten JEPA
pretraining steps on the CPU at f32, each step fed the JAX step's own draws.

Geometry and configs are those of ``tests/test_torch_jepa.py`` (96 px, patch
8, encoder 48/2/4; MAE decoder 32/1/4, JEPA predictor 32/1/4) with B=4, a
new batch each step, ``total_epochs=4``, ``warmup_epochs=2`` and
``on_fit_start(steps_per_epoch=3)`` on both sides, the trainer's order. The
epoch index goes into ``train_step`` as the trainer passes it (0, 0, 0, 1,
..., 3), so the ten steps cross the warmup into the cosine decay and three
epoch boundaries: the learning rate moves per epoch and JEPA's EMA momentum
per step. Each step's draws come from the JAX state's key as
``Task._local_train_step`` makes them (``split(state.rng, 3)``, then
``draw_augment_params`` and the task's masks) and go into the port's
``train_step(..., draws=...)``; MAE's ``ctx`` is each epoch's
``epoch_context``. The mask ratio is the texture study's constant 0.75, so
the JAX step compiles once a task.

Tolerances: every step's metric sums within rel 1e-4 and ``lr`` and the
momentum within rel 1e-6; at the end every parameter within 2·Σlr (Σ over
the steps, at most 2·N·lr) of the JAX state, the 99th percentile of the
absolute differences within lr/100 (lr the peak rate; tighter than 2·lr,
which an optimizer constant slips past: Adam's β2 at 0.99 instead of 0.999
moves the MAE fit's 99th percentile to 3.4e-6, 0.03·lr, against 1.3e-8
for the port as it is), and JEPA's EMA target within the same bounds times
(1 − m) of the first step (its largest), plus 1e-6 for the EMA's own f32
rounding of tensors near 1 (the LayerNorm scales). A training-recipe fault
(schedule, optimizer, EMA, draws, loss) shows here as a drift that grows
step after step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils.interop import (
    jepa_params_to_state,
    mae_params_to_state,
    vit_params_to_state,
)
from ssrl_vit_mae_jepa_tpu.ops import jepa_masking as jm
from ssrl_vit_mae_jepa_tpu.ops.augment import draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.state import TrainState as JTrainState
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti

MODEL = {
    "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
    "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
    "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
}
SCHEDULE = {"total_epochs": 4, "warmup_epochs": 2, "batch_size": 4,
            "base_learning_rate": 1e-2, "weight_decay": 0.05}
MAE_CFG = {**SCHEDULE, "mask_ratio_start": 0.75, "mask_ratio_end": 0.75,
           "mask_ramp_epochs": 5}
JEPA_CFG = {
    **SCHEDULE, "predictor_embed_dim": 32, "predictor_depth": 1,
    "predictor_num_heads": 4, "num_target_blocks": 4, "target_scale": [0.15, 0.2],
    "target_aspect_ratio": [0.75, 1.5], "ema_start": 0.99, "ema_end": 1.0,
}
B, STEPS, STEPS_PER_EPOCH = 4, 10, 3
WEIGHT = np.array([1.0, 1.0, 0.5, 1.0], np.float32)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _batches():
    for step in range(STEPS):
        images = np.random.default_rng(step).integers(0, 256, (B, 96, 96, 3), np.uint8)
        yield step // STEPS_PER_EPOCH, {"image": images, "label": np.zeros(B, np.int32),
                                        "weight": WEIGHT}


def _start(jtask, ttask):
    """The port's seeded init on both sides: the JAX params through the JAX
    package's importers (no flax init to compile), a fresh optax state."""
    tstate = ttask.init_state(0)
    st = {k: v.detach().numpy().copy() for k, v in tstate.params.items()}
    sub = lambda pre: {k[len(pre):]: v for k, v in st.items() if k.startswith(pre)}  # noqa
    depth = MODEL["encoder"]["depth"]
    if isinstance(ttask, TJEPATask):
        params = {"encoder": ti.timm_vit_to_params(sub("encoder."), depth)[0],
                  "predictor": ti.lightly_decoder_to_params(
                      sub("predictor."), JEPA_CFG["predictor_depth"])[0],
                  "predictor_proj": {"kernel": st["predictor_proj.weight"].T,
                                     "bias": st["predictor_proj.bias"]}}
    else:
        params = ti.mae_state_to_params(st, depth, MODEL["decoder"]["decoder_depth"])[0]
    params = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(params=params, opt_state=jtask.build_optimizer(params),
                         rng=jax.random.PRNGKey(1), step=jnp.zeros((), jnp.int32),
                         extra=jtask.init_extra(params))
    return jstate, tstate


def _long(*arrays):
    return tuple(torch.from_numpy(np.array(a)).long() for a in arrays)


def _fit(jtask, jstate, tstate, ttask, draw_task):
    """Both fits side by side; returns the final states and, per step, the
    port's and JAX's sums (with ``lr``) and the port's momentum."""
    jtask.on_fit_start(steps_per_epoch=STEPS_PER_EPOCH)
    ttask.on_fit_start(steps_per_epoch=STEPS_PER_EPOCH)
    steps = []
    for epoch, batch in _batches():
        ctx = jtask.epoch_context(epoch)
        assert ttask.epoch_context(epoch) == ctx
        _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
        u, flip = draw_augment_params(aug_rng, B)
        draws = (torch.from_numpy(np.array(u)), torch.from_numpy(np.array(flip)),
                 *_long(*draw_task(jtask, task_rng, ctx)))
        jstate, jsums = jtask.train_step(jstate, batch, epoch, ctx)
        tbatch = {"image": torch.from_numpy(batch["image"]),
                  "weight": torch.from_numpy(batch["weight"])}
        tstate, tsums = ttask.train_step(tstate, tbatch, epoch, ctx, draws=draws)
        m = None
        if isinstance(ttask, TJEPATask):  # each side's momentum of this update
            m = (float(ttask._momentum(tstate, epoch)), float(jtask._momentum(jstate, epoch)))
        steps.append(({k: float(v) for k, v in tsums.items()},
                      {k: float(v) for k, v in jsums.items()}, m))
    assert tstate.step == STEPS and int(jstate.step) == STEPS
    return jstate, tstate, steps


def _check_steps(steps):
    lrs = []
    for i, (mine, want, _) in enumerate(steps):
        assert set(mine) == set(want), i
        assert mine["lr"] == pytest.approx(want["lr"], rel=1e-6), i
        for k, v in want.items():
            assert mine[k] == pytest.approx(v, rel=1e-4), (i, k)
        lrs.append(mine["lr"])
    # the window crosses the warmup into the cosine decay
    assert lrs[0] < lrs[3] and lrs[3] > lrs[6] > lrs[9] > 0
    return sum(lrs), max(lrs)


def _check_tensors(mine, want, total, peak, what):
    assert set(mine) == set(want), (what, set(mine) ^ set(want))
    diffs = []
    for name, v in mine.items():
        d = np.abs(v.detach().numpy() - want[name])
        assert d.max() <= total, (what, name, d.max(), total)
        diffs.append(d.ravel())
    p99 = np.percentile(np.concatenate(diffs), 99)
    assert p99 <= peak, (what, p99, peak)


def _mae_masks(jtask, task_rng, ctx):
    return random_token_mask(task_rng, B, jtask.sequence_length, ctx)


def _jepa_masks(jtask, task_rng, ctx):
    return jm.sample_jepa_masks(
        task_rng, B, jtask.grid_size, jtask.num_blocks, jtask.block_area,
        jtask.context_size, jtask.aspect_range, context_sampling=jtask.context_sampling,
        context_scale=jtask.context_scale)


def test_mae_fit_follows_the_jax_fit():
    jtask = JMAETask(MODEL, MAE_CFG, dtype=jnp.float32)
    ttask = TMAETask(MODEL, MAE_CFG, dtype=torch.float32, device="cpu")
    jstate, tstate, steps = _fit(jtask, *_start(jtask, ttask), ttask, _mae_masks)
    total, peak = _check_steps(steps)
    want = mae_params_to_state(_np_tree(jstate.params))
    del want["encoder.mask_token"]  # the export's token of the JAX layout: no port param
    _check_tensors(tstate.params, want, 2 * total, peak / 100, "params")


def test_jepa_fit_follows_the_jax_fit():
    """The EMA target starts perturbed away from the context encoder (as in
    ``tests/test_torch_jepa.py``), so the target tower has weights of its
    own from the first step."""
    jtask = JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32)
    ttask = TJEPATask(MODEL, JEPA_CFG, dtype=torch.float32, device="cpu")
    jstate, tstate = _start(jtask, ttask)
    noise = jax.random.split(jax.random.PRNGKey(7), len(jax.tree.leaves(jstate.extra)))
    leaves, tdef = jax.tree.flatten(jstate.extra)
    jstate = jstate.replace(extra=jax.tree.unflatten(
        tdef, [a + 0.02 * jax.random.normal(k, a.shape) for a, k in zip(leaves, noise)]))
    tstate.extra = {k: torch.from_numpy(v)
                    for k, v in vit_params_to_state(_np_tree(jstate.extra)).items()}
    jstate, tstate, steps = _fit(jtask, jstate, tstate, ttask, _jepa_masks)
    total, peak = _check_steps(steps)
    ms = [m for _, _, m in steps]
    for i, (mine, want) in enumerate(ms):
        assert mine == pytest.approx(want, rel=1e-6), i
    assert ms[0][0] < ms[3][0] < ms[-1][0] < 1.0  # per step, not per epoch
    _check_tensors(tstate.params, jepa_params_to_state(_np_tree(jstate.params)),
                   2 * total, peak / 100, "params")
    one_minus_m = 1.0 - ms[0][0]
    _check_tensors(tstate.extra, vit_params_to_state(_np_tree(jstate.extra)),
                   2 * total * one_minus_m + 1e-6, peak / 100 * one_minus_m + 1e-6, "ema")
