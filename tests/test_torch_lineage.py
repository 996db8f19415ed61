"""The lineage paths of the training step, the port against the JAX package
on the CPU: the image-space augmentation (``SSRL_AUG_PATCHES=0``), the
un-augmented path (``augment: false``, quirk Q1) and the dense MAE and JEPA
losses (``SSRL_MAE_DENSE_LOSS=1``, ``SSRL_JEPA_DENSE_LOSS=1``).

Geometry: 96 px, patch 8, encoder 48/2/4; the MAE decoder and the JEPA
predictor 32/1/4; 10 classes; B=4 with one half-weight row. The JAX side
runs its flax path (``block_impl`` is None off the TPU), from the same
params. JAX's draws are made as ``Task._local_train_step`` makes them
(``split(state.rng, 3)``: the augmentation from the second key when
augmentation is on, the masks from the third) and injected into the port.

Tolerances: ``apply_augment`` as ``tests/test_torch_ops.py`` holds
``apply_augment_patches`` (atol 1e-5 op by op, 6e-5 against the jitted JAX
function); the dense forwards atol 1e-6 + rtol 1e-4 in f32 and the bf16
forward bound of ``tests/test_torch_block.py`` (6e-2); a step's loss rel
1e-5 and gradients atol 1e-6 + rtol 1e-4 in f32, and its params within
2·lr of the JAX step's, 1e-3·lr where the gradient is clearly nonzero
(``tests/test_torch_classifier.py``: Adam's first step is ±lr whatever the
gradient's size, so a near-zero gradient may flip its sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.models.jepa import jepa_from_config as t_jepa
from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config as t_mae
from ssrl_vit_mae_jepa_torch.ops import augment as t_aug
from ssrl_vit_mae_jepa_torch.ops.masking import token_occupancy
from ssrl_vit_mae_jepa_torch.ops.patches import patchify as t_patchify
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask as TClassifierTask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_tpu.models.jepa import jepa_from_config as j_jepa
from ssrl_vit_mae_jepa_tpu.models.mae import mae_from_config as j_mae
from ssrl_vit_mae_jepa_tpu.ops import augment as j_aug
from ssrl_vit_mae_jepa_tpu.ops.jepa_masking import sample_jepa_masks
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.state import TrainState as JTrainState
from ssrl_vit_mae_jepa_tpu.training.tasks import ClassifierTask as JClassifierTask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti

GENERAL = {"image_size": 96, "patch_size": 8, "in_chans": 3}
ENCODER = {"embed_dim": 48, "depth": 2, "num_heads": 4}
MAE_MODEL = {"general": GENERAL, "encoder": ENCODER,
             "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4}}
CLS_MODEL = {"general": GENERAL, "encoder": ENCODER, "head": {"pool": "cls"}}
# warmup 1 and a large base LR, so that one step moves every param by ~lr
PRE_CFG = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
           "total_epochs": 800, "warmup_epochs": 1, "batch_size": 4,
           "base_learning_rate": 1e-2, "weight_decay": 0.05}
JEPA_CFG = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": 4,
            "base_learning_rate": 1e-2, "weight_decay": 0.05,
            "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4,
            "num_target_blocks": 4, "target_scale": [0.15, 0.2],
            "target_aspect_ratio": [0.75, 1.5], "ema_start": 0.99, "ema_end": 1.0}
TRAIN = {"learning_rate": 1e-2, "weight_decay": 0.05, "warmup_epochs": 1,
         "total_epochs": 10, "batch_size": 4}
B = 4
EPOCH = 1
# the rng of a JAX train state made from PRNGKey(0) (``Task.init_state``)
STATE_RNG = jax.random.split(jax.random.PRNGKey(0))[1]
F32_TOL = {"atol": 1e-6, "rtol": 1e-4}
BF16_ATOL = 6e-2
ENV = {"mae": "SSRL_MAE_DENSE_LOSS", "jepa": "SSRL_JEPA_DENSE_LOSS"}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (B, 96, 96, 3)).astype(np.uint8),
            "label": rng.integers(0, 10, B).astype(np.int32),
            "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# the image-space augmentation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("jit,atol", [(False, 1e-5), (True, 6e-5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_augment_matches_jax(seed, jit, atol):
    """JAX-drawn (u, flip) into both, f32 (the bounds of
    ``test_torch_ops.py::test_apply_augment_patches_matches_jax``)."""
    images = np.random.default_rng(seed).integers(0, 256, (4, 96, 96, 3)).astype(np.uint8)
    u, flip = j_aug.draw_augment_params(jax.random.PRNGKey(seed), 4)
    with jax.disable_jit(not jit):
        want = j_aug.apply_augment(u, flip, images, out_size=96)
    got = t_aug.apply_augment(_t(u), _t(flip), torch.from_numpy(images), out_size=96)
    assert got.shape == (4, 96, 96, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_patchify_of_apply_augment_is_apply_augment_patches(seed):
    """The two train transforms are one resample in two layouts: exact."""
    images = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (3, 96, 96, 3)).astype(np.uint8))
    u, flip = t_aug.draw_augment_params(torch.Generator().manual_seed(seed), 3)
    want = t_aug.apply_augment_patches(u, flip, images, patch_size=8, out_size=96)
    assert torch.equal(t_patchify(t_aug.apply_augment(u, flip, images, out_size=96), 8), want)


def test_random_resized_crop_flip_normalize_draws_then_applies():
    images = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (3, 96, 96, 3)).astype(np.uint8))
    got = t_aug.random_resized_crop_flip_normalize(torch.Generator().manual_seed(5), images)
    u, flip = t_aug.draw_augment_params(torch.Generator().manual_seed(5), 3)
    assert torch.equal(got, t_aug.apply_augment(u, flip, images))


# --------------------------------------------------------------------------
# the task's dispatch and draws
# --------------------------------------------------------------------------


def _task(kind, augment=True, dtype=torch.float32):
    if kind == "mae":
        return TMAETask(MAE_MODEL, {**PRE_CFG, "augment": augment}, dtype=dtype, device="cpu")
    if kind == "jepa":
        return TJEPATask(MAE_MODEL, {**JEPA_CFG, "augment": augment}, dtype=dtype,
                         device="cpu")
    t = TClassifierTask(CLS_MODEL, TRAIN, dtype=dtype, device="cpu", augment=augment)
    t.set_freeze_policy(freeze_encoder=False)
    return t


@pytest.mark.parametrize("kind", ["mae", "jepa", "cls"])
def test_unaugmented_task_draws_no_augmentation(kind):
    """Augmentation off: ``(None, None, *masks)``, and the generator gives
    the task's draws as if nothing else drew from it."""
    task = _task(kind, augment=False)
    ctx = task.epoch_context(0)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    u, flip, *masks = task.draw(g1, B, ctx)
    want = task.draw_task(g2, B, ctx)
    assert u is None and flip is None and len(masks) == len(want)
    for a, b in zip(masks, want):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def test_preprocess_train_dispatch(monkeypatch):
    """Augment on: patch tokens; ``SSRL_AUG_PATCHES=0``: images; off:
    ``eval_transform``, whatever the draws."""
    images = _tbatch(_batch())["image"]
    task = _task("mae")
    u, flip = t_aug.draw_augment_params(torch.Generator().manual_seed(0), B)
    tokens = task.preprocess_train(u, flip, images)
    assert torch.equal(tokens, t_aug.apply_augment_patches(u, flip, images))
    monkeypatch.setenv("SSRL_AUG_PATCHES", "0")
    assert torch.equal(task.preprocess_train(u, flip, images),
                       t_aug.apply_augment(u, flip, images))
    off = _task("mae", augment=False)
    assert torch.equal(off.preprocess_train(None, None, images), t_aug.eval_transform(images))


def test_dense_loss_switch_takes_the_dense_route(monkeypatch):
    """``SSRL_MAE_DENSE_LOSS=1`` (read when the task is made) sends the loss
    through ``forward_dense`` and never through the gathered forward."""
    monkeypatch.setenv("SSRL_MAE_DENSE_LOSS", "1")
    task = _task("mae")
    assert task.dense_loss
    state = task.init_state(0)
    calls = []
    dense = task.model.forward_dense
    monkeypatch.setattr(task.model, "forward_dense",
                        lambda *a: calls.append("dense") or dense(*a))
    monkeypatch.setattr(task.model, "forward", lambda *a: calls.append("gathered"))
    task.train_step(state, _tbatch(_batch()), EPOCH, task.epoch_context(0))
    assert calls == ["dense"]
    monkeypatch.delenv("SSRL_MAE_DENSE_LOSS")
    assert not _task("mae").dense_loss


# --------------------------------------------------------------------------
# the dense forwards against the JAX methods
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mae_params():
    return _np(JMAETask(MAE_MODEL, PRE_CFG, dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jepa_params():
    """JEPA params and an EMA target perturbed away from the encoder."""
    params = _np(JJEPATask(MAE_MODEL, JEPA_CFG, dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0)))
    leaves, tdef = jax.tree.flatten(params["encoder"])
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    extra = [np.array(a + 0.02 * jax.random.normal(k, a.shape), np.float32)
             for a, k in zip(leaves, keys)]
    return params, jax.tree.unflatten(tdef, extra)


@pytest.fixture(scope="module")
def cls_params():
    task = _task("cls")
    task.init_state(0)
    state = {k: v.detach().numpy() for k, v in task.model.state_dict().items()}
    params, report = ti.classifier_state_to_params(state, depth=2)
    assert report == {"missing": [], "unexpected": []}
    return params


def _images_and_masks(n_keep_seed=0):
    images = np.array(j_aug.eval_transform(_batch()["image"]))
    idx_keep, idx_mask = random_token_mask(jax.random.PRNGKey(n_keep_seed), B, 145, 108)
    return images, np.array(idx_keep), np.array(idx_mask)


def _close(got, want, dtype):
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_dense_matches_jax(mae_params, dtype):
    """From (B, H, W, C) images, so the in-model patchify runs too."""
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    images, idx_keep, _ = _images_and_masks()
    pred, target = j_mae(MAE_MODEL, dtype=jd).apply(
        {"params": mae_params}, images, idx_keep, method="forward_dense")
    model = interop.mae_params_from_jax(mae_params, t_mae(MAE_MODEL, dtype=td))
    with torch.no_grad():
        tpred, ttarget = model.forward_dense(torch.from_numpy(images), torch.from_numpy(idx_keep))
    assert tpred.shape == (B, 145, 192) and ttarget.shape == (B, 144, 192)
    _close(tpred, np.asarray(pred, np.float32), dtype)
    np.testing.assert_array_equal(ttarget.numpy(), np.asarray(target))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_predict_dense_and_target_dense_match_jax(jepa_params, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    params, extra = jepa_params
    images = np.array(j_aug.eval_transform(_batch()["image"]))
    t_idx, c_idx = sample_jepa_masks(jax.random.PRNGKey(1), B, 12, 4, 24, 48, (0.75, 1.5))
    idx_ctx = np.array(JJEPATask._ctx_tokens(c_idx))
    jm = j_jepa(MAE_MODEL, JEPA_CFG, dtype=jd)
    pred = jm.apply({"params": params}, images, idx_ctx, method=jm.predict_dense)
    target = jm.apply({"params": {"encoder": extra}}, images,
                      method=jm.target_representations_dense)
    model = interop.jepa_params_from_jax(params, t_jepa(MAE_MODEL, JEPA_CFG, dtype=td))
    ema = {k: torch.from_numpy(v) for k, v in interop.vit_params_to_state(extra).items()}
    with torch.no_grad():
        tpred = model.predict_dense(torch.from_numpy(images), torch.from_numpy(idx_ctx))
        ttarget = model.target_representations_dense(ema, torch.from_numpy(images))
    assert tpred.shape == ttarget.shape == (B, 145, 48)
    _close(tpred, np.asarray(pred, np.float32), dtype)
    _close(ttarget, np.asarray(target, np.float32), dtype)


# --------------------------------------------------------------------------
# whole steps against the JAX task's
# --------------------------------------------------------------------------

CASES = [("mae", "off"), ("mae", "images"), ("mae", "dense"),
         ("jepa", "off"), ("jepa", "images"), ("jepa", "dense"),
         ("cls", "off"), ("cls", "images")]


def _set_route(monkeypatch, kind, route):
    for var in ("SSRL_AUG_PATCHES", *ENV.values()):
        monkeypatch.delenv(var, raising=False)
    if route == "images":
        monkeypatch.setenv("SSRL_AUG_PATCHES", "0")
    elif route == "dense":
        monkeypatch.setenv(ENV[kind], "1")


def _pair(kind, route, mae_params, jepa_params, cls_params):
    """The JAX task and state, and the port's, from the same params."""
    augment = route != "off"
    extra = None
    if kind == "mae":
        jt = JMAETask(MAE_MODEL, {**PRE_CFG, "augment": augment}, dtype=jnp.float32)
        params = mae_params
    elif kind == "jepa":
        jt = JJEPATask(MAE_MODEL, {**JEPA_CFG, "augment": augment}, dtype=jnp.float32)
        params, extra = jepa_params
    else:
        jt = JClassifierTask(CLS_MODEL, TRAIN, dtype=jnp.float32, augment=augment)
        jt.set_freeze_policy(freeze_encoder=False)
        params = cls_params
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(params=jparams, opt_state=jt.build_optimizer(jparams),
                         rng=jnp.array(STATE_RNG), step=jnp.zeros((), jnp.int32),
                         extra=None if extra is None else jax.tree.map(jnp.asarray, extra))
    tt = _task(kind, augment)
    ts = tt.init_state(0)
    convert = {"mae": interop.mae_params_from_jax, "jepa": interop.jepa_params_from_jax,
               "cls": interop.classifier_params_from_jax}[kind]
    convert(params, tt.model)
    if extra is not None:
        ts.extra = {k: torch.from_numpy(v) for k, v in interop.vit_params_to_state(extra).items()}
    return jt, jstate, tt, ts


def _jax_draws(kind, jt, augment):
    """``(aug_rng, task_rng)`` of the JAX step and the draws to inject."""
    _, aug_rng, task_rng = jax.random.split(STATE_RNG, 3)
    aug = tuple(map(_t, j_aug.draw_augment_params(aug_rng, B))) if augment else (None, None)
    if kind == "mae":
        masks = random_token_mask(task_rng, B, jt.sequence_length, jt.epoch_context(EPOCH))
    elif kind == "jepa":
        masks = sample_jepa_masks(task_rng, B, jt.grid_size, jt.num_blocks, jt.block_area,
                                  jt.context_size, jt.aspect_range,
                                  context_sampling=jt.context_sampling,
                                  context_scale=jt.context_scale)
    else:
        masks = ()
    return aug_rng, task_rng, (*aug, *(_t(m).long() for m in masks))


def _to_state(kind, tree):
    return {"mae": interop.mae_params_to_state, "jepa": interop.jepa_params_to_state,
            "cls": interop.classifier_params_to_state}[kind](_np(tree))


@pytest.mark.parametrize("kind,route", CASES)
def test_step_matches_the_jax_step(monkeypatch, mae_params, jepa_params, cls_params, kind,
                                   route):
    """The loss, the metric sums, every gradient and the params (and JEPA's
    EMA target) after one step, under each lineage route, against the JAX
    task's step from the same params and draws."""
    _set_route(monkeypatch, kind, route)
    jt, jstate, tt, ts = _pair(kind, route, mae_params, jepa_params, cls_params)
    assert tt.augment == jt.augment == (route != "off")
    if kind in ENV:
        assert tt.dense_loss == jt.dense_loss == (route == "dense")
    batch = _batch()
    ctx = jt.epoch_context(EPOCH)
    aug_rng, task_rng, draws = _jax_draws(kind, jt, tt.augment)
    jimages = jt.preprocess_train(aug_rng, batch["image"])
    assert jimages.ndim == (3 if route == "dense" else 4)

    def loss_fn(p):
        return jt.loss_and_metric_sums_in_step(p, jstate, jimages, batch, task_rng, ctx)

    (jloss, jsums), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    jnew, jstep_sums = jt.train_step(jax.tree.map(jnp.array, jstate), batch, EPOCH, ctx)

    tbatch = _tbatch(batch)
    names, grads, sums = tt.gradients(ts, tbatch, ctx, draws)
    assert set(sums) == set(jsums)
    for k, v in jsums.items():
        assert float(sums[k]) == pytest.approx(float(v), rel=1e-5), k
    loss = float(sums["loss_sum"]) / max(float(sums["weight_sum"]), 1.0)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    gwant = _to_state(kind, jgrads)
    assert set(names) == set(gwant) - {"encoder.mask_token"}
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), gwant[k], **F32_TOL, err_msg=k)

    before = {k: v.detach().clone() for k, v in ts.params.items()}
    extra0 = None if ts.extra is None else {k: v.clone() for k, v in ts.extra.items()}
    ts, tsums = tt.train_step(ts, tbatch, EPOCH, ctx, draws)
    lr = tsums["lr"]
    assert lr == pytest.approx(float(jstep_sums["lr"]), rel=1e-6)
    assert float(tsums["loss_sum"]) == pytest.approx(float(jstep_sums["loss_sum"]), rel=1e-5)
    want = _to_state(kind, jnew.params)
    for k, p in ts.params.items():
        p = p.detach().numpy()
        assert np.abs(p - before[k].numpy()).max() > 0.5 * lr, k
        np.testing.assert_allclose(p, want[k], atol=2 * lr, rtol=0, err_msg=k)
        sure = np.abs(gwant[k]) > 1e-3 * np.abs(gwant[k]).max()
        np.testing.assert_allclose(p[sure], want[k][sure], atol=1e-3 * lr, rtol=0, err_msg=k)
    if kind == "jepa":
        m = tt._momentum(ts, EPOCH)
        ema_want = interop.vit_params_to_state(_np(jnew.extra))
        for k, v in ts.extra.items():
            mine = extra0[k] * m + ts.params["encoder." + k].detach() * (1 - m)
            torch.testing.assert_close(v, mine, atol=1e-7, rtol=0)
            np.testing.assert_allclose(v.numpy(), ema_want[k], atol=2 * lr * (1 - m) + 1e-6,
                                       rtol=0, err_msg=k)


# --------------------------------------------------------------------------
# dense ≡ gathered inside the port
# --------------------------------------------------------------------------


def _dense_vs_gathered(monkeypatch, kind, draws_fn):
    """The same state and draws through both routes: the loss, the sums and
    every gradient agree to f32 summation order."""
    out = []
    for dense in ("0", "1"):
        monkeypatch.setenv(ENV[kind], dense)
        task = _task(kind)
        state = task.init_state(0)
        draws = draws_fn(task, state)
        out.append(task.gradients(state, _tbatch(_batch()), task.epoch_context(EPOCH), draws))
    (names, g0, s0), (names1, g1, s1) = out
    assert names == names1 and set(s0) == set(s1)
    for k in s0:
        assert float(s1[k]) == pytest.approx(float(s0[k]), rel=1e-5), k
    for k, a, b in zip(names, g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL, err_msg=k)


def test_mae_dense_equals_gathered(monkeypatch):
    _dense_vs_gathered(monkeypatch, "mae", lambda t, s: t.draw(
        torch.Generator().manual_seed(4), B, t.epoch_context(EPOCH)))


@pytest.mark.parametrize("overlap", [False, True])
def test_jepa_dense_equals_gathered(monkeypatch, overlap):
    """With ``overlap`` every example's second target block is its first:
    those tokens count twice, in the gathered rows and in the occupancy."""
    def draws(task, state):
        u, flip, t_idx, c_idx = task.draw(torch.Generator().manual_seed(4), B, None)
        if overlap:
            a = task.block_area
            t_idx = t_idx.clone()
            t_idx[:, a:2 * a] = t_idx[:, :a]
            assert token_occupancy(t_idx + 1, task.sequence_length).max() >= 2
        return u, flip, t_idx, c_idx

    _dense_vs_gathered(monkeypatch, "jepa", draws)


def test_token_occupancy_is_the_one_hot_sum():
    idx = np.array([[1, 3, 3, 7], [0, 2, 5, 5]])
    want = np.asarray(jax.nn.one_hot(idx, 9, dtype=jnp.float32).sum(axis=1))
    np.testing.assert_array_equal(token_occupancy(torch.from_numpy(idx), 9).numpy(), want)
