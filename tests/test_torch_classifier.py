"""The classifier stage of the port against the JAX package, on the CPU.

The forward (CLS and mean pool) against flax ``ViTClassifier``; one
``ClassifierTask.train_step`` under the three freeze policies (full
fine-tune, ``freeze_encoder``, ``unfreeze_last_layers=1``) against the JAX
``ClassifierTask.train_step`` from the same params and augment draws
(JAX's, injected); the trainable mask against ``trainable_mask``; the eval
steps of the three tasks against the JAX ``eval_step``; ``eval_transform``
at 96 and at 112 px; ``epoch_metrics_from_sums``; and one step under
``attn_impl="chain"`` through the chain's plain version.

Geometry: 96 px, patch 8, encoder 48/2/4 (L=145), 10 classes, B=4 with one
half-weight row. The JAX side runs the flax path (``block_impl`` is None
off the TPU). Tolerances: f32 loss rel 1e-5, gradients and Adam moments
atol 1e-6 + rtol 1e-4; bf16 loss rel 2e-2 and gradients 10% of their
largest magnitude. Adam's first step is ±lr per element whatever the
gradient's size, so the params after a step are held to 1e-3·lr where the
gradient is clearly nonzero (|g| > 1e-3 of its tensor's largest) and to
2·lr elsewhere, where a near-zero gradient may differ in sign. Frozen
params must keep their bits. ``eval_transform`` is held to atol 1e-5 (the
resize sums its taps in another order than XLA's einsum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssrl_vit_mae_jepa_torch.ops.augment import eval_transform as t_eval_transform
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.optim import count_trainable as t_count_trainable
from ssrl_vit_mae_jepa_torch.training.optim import trainable_mask as t_trainable_mask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask as TClassifierTask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_tpu.models.classifier import classifier_from_config as j_classifier
from ssrl_vit_mae_jepa_tpu.ops.augment import apply_augment_patches, draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.augment import eval_transform as j_eval_transform
from ssrl_vit_mae_jepa_tpu.ops.jepa_masking import sample_jepa_masks
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.optim import count_trainable as j_count_trainable
from ssrl_vit_mae_jepa_tpu.training.optim import trainable_mask as j_trainable_mask
from ssrl_vit_mae_jepa_tpu.training.state import TrainState as JTrainState
from ssrl_vit_mae_jepa_tpu.training.tasks import ClassifierTask as JClassifierTask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti

GENERAL = {"image_size": 96, "patch_size": 8, "in_chans": 3}
ENCODER = {"embed_dim": 48, "depth": 2, "num_heads": 4}
MODEL = {"general": GENERAL, "encoder": ENCODER, "head": {"pool": "cls"}}
# warmup 1 and a large lr, so that one step moves every trainable param
TRAIN = {"learning_rate": 1e-2, "weight_decay": 0.05, "warmup_epochs": 1,
         "total_epochs": 10, "batch_size": 4}
POLICIES = {"full": (False, None), "probe": (True, None), "unfreeze1": (False, 1)}
B = 4


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _port_state(task) -> dict:
    """The port's seeded init as a numpy state dict (the JAX package's
    converters then make the flax tree: no flax init to compile)."""
    task.init_state(0)
    return {k: v.detach().float().numpy() for k, v in task.model.state_dict().items()}


# the rng of a JAX train state made from PRNGKey(0) (``Task.init_state``)
STATE_RNG = jax.random.split(jax.random.PRNGKey(0))[1]


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (B, 96, 96, 3)).astype(np.uint8),
            "label": rng.integers(0, 10, B).astype(np.int32),
            "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jtask(policy, dtype=jnp.float32, model=MODEL):
    t = JClassifierTask(model, TRAIN, dtype=dtype)
    fe, un = POLICIES[policy]
    t.set_freeze_policy(freeze_encoder=fe, unfreeze_last_layers=un)
    return t


def _ttask(policy, dtype=torch.float32, model=MODEL, attn_impl="auto"):
    t = TClassifierTask(model, TRAIN, dtype=dtype, device="cpu", attn_impl=attn_impl)
    fe, un = POLICIES[policy]
    t.set_freeze_policy(freeze_encoder=fe, unfreeze_last_layers=un)
    return t


@pytest.fixture(scope="module")
def params0():
    params, report = ti.classifier_state_to_params(_port_state(_ttask("full")), depth=2)
    assert report == {"missing": [], "unexpected": []}
    return params


@pytest.fixture(scope="module")
def jax_grads(params0):
    """The JAX loss and every gradient at params0 with the step's draws
    (a frozen param's stop_gradient does not change a trainable one's)."""
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jt = _jtask("full", dtype)
        _, aug_rng, _ = jax.random.split(STATE_RNG, 3)
        u, flip = draw_augment_params(aug_rng, B)
        batch = _batch()
        images = apply_augment_patches(u, flip, batch["image"], patch_size=8, out_size=96)

        def loss_fn(p):
            return jt.loss_and_metric_sums(p, images, batch, None, None)

        (loss, sums), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params0)
        out[name] = dict(loss=float(loss), sums=_np(sums), grads=_np(grads),
                         draws=(torch.from_numpy(np.array(u)), torch.from_numpy(np.array(flip))))
    return out


def test_task_runs_on_the_card_unless_told_otherwise():
    assert TClassifierTask(MODEL, TRAIN).device == torch.device("cuda")
    assert TClassifierTask(MODEL, TRAIN, device="cpu").device == torch.device("cpu")
    assert TClassifierTask.monitor == "val_acc" and TClassifierTask.monitor_mode == "max"
    assert TMAETask.monitor == "val_loss" and TMAETask.monitor_mode == "min"
    assert TJEPATask.monitor == "val_loss" and TJEPATask.monitor_mode == "min"


def test_export_matches_the_jax_package(params0):
    """The port's own ``classifier_params_to_state`` gives the JAX export."""
    from ssrl_vit_mae_jepa_tpu.utils.torch_interop import classifier_params_to_state

    mine, want = interop.classifier_params_to_state(params0), classifier_params_to_state(params0)
    assert list(mine) == list(want)
    for k, v in want.items():
        assert mine[k].dtype == v.dtype and np.array_equal(mine[k], v), k


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_flax(params0, pool, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    model = {**MODEL, "head": {"pool": pool}}
    jm = j_classifier(model, dtype=jd)
    images = np.array(j_eval_transform(_batch()["image"]))
    want = np.asarray(jm.apply({"params": params0}, images))
    tm = interop.classifier_params_from_jax(params0, _ttask("full", td, model).model)
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_trainable_mask_matches_the_jax_package(params0, policy):
    fe, un = POLICIES[policy]
    jmask = j_trainable_mask(params0, freeze_encoder=fe, unfreeze_last_layers=un, depth=2)
    full = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params0)
    want = {k: bool(v.all()) for k, v in interop.classifier_params_to_state(full).items()}
    t = _ttask(policy)
    tstate = t.init_state(0)
    assert t.mask == want
    assert t_trainable_mask(tstate.params, fe, un, depth=2) == want
    assert t_count_trainable(tstate.params, t.mask) == j_count_trainable(params0, jmask)
    assert {k: p.requires_grad for k, p in tstate.params.items()} == want
    if policy == "unfreeze1":  # the last block, the final norm and the head
        trained = {k for k, v in want.items() if v}
        assert trained == ({k for k in want if k.startswith("encoder.blocks.1.")}
                           | {"encoder.norm.weight", "encoder.norm.bias",
                              "head.classification.weight", "head.classification.bias"})


def test_unfreeze_out_of_range_raises():
    for n in (-1, 3):
        t = _ttask("full")
        t.set_freeze_policy(unfreeze_last_layers=n)
        with pytest.raises(ValueError, match="between 0 and 2"):
            t.init_state(0)


def _adam_moments(opt_state, params):
    """(mu, nu) of the JAX masked AdamW state by torch names; frozen leaves
    (``MaskedNode``) dropped."""
    adam = opt_state.inner_state.inner_state[1][0]
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    out = []
    for tree in (adam.mu, adam.nu):
        filled = jax.tree.map(lambda m, p: np.full(p.shape, np.nan, np.float32)
                              if masked(m) else np.array(m, np.float32),
                              tree, params, is_leaf=masked)
        out.append({k: v for k, v in interop.classifier_params_to_state(filled).items()
                    if not np.isnan(v).all()})
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_train_step_matches(params0, jax_grads, policy, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jax_grads[dtype]
    batch = _batch()
    jt = _jtask(policy, jd)
    jparams = jax.tree.map(jnp.asarray, params0)
    jstate = JTrainState(params=jparams, opt_state=jt.build_optimizer(jparams),
                         rng=jnp.array(STATE_RNG),
                         step=jnp.zeros((), jnp.int32))
    jnew, jsums = jt.train_step(jstate, batch, 0)
    want = interop.classifier_params_to_state(_np(jnew.params))
    before = interop.classifier_params_to_state(params0)
    grads_want = interop.classifier_params_to_state(ref["grads"])

    t = _ttask(policy, td)
    tstate = t.init_state(0)
    interop.classifier_params_from_jax(params0, t.model)
    trainable = t.tx.trainable(tstate.params)
    # the gradients the port's step takes, from the same draws
    images = t.preprocess_train(*ref["draws"], _tbatch(batch)["image"])
    loss, _ = t.loss_and_metric_sums(images, _tbatch(batch), (), None)
    grads = dict(zip(trainable, torch.autograd.grad(loss, [tstate.params[k] for k in trainable])))
    tstate, tsums = t.train_step(tstate, _tbatch(batch), 0, None, draws=ref["draws"])

    lr = tsums["lr"]
    assert lr == pytest.approx(float(jsums["lr"]), rel=1e-6)
    assert float(tsums["weight_sum"]) == float(jsums["weight_sum"])
    for k in ("acc_sum", "top5_sum"):  # bf16: a near-tie of two logits may flip
        assert abs(float(tsums[k]) - float(jsums[k])) <= (0.0 if dtype == "f32" else 1.0), k
    rel = 1e-5 if dtype == "f32" else 2e-2
    assert float(tsums["loss_sum"]) == pytest.approx(float(jsums["loss_sum"]), rel=rel)
    assert loss.item() == pytest.approx(ref["loss"], rel=rel)
    for k, g in grads.items():
        g, w = g.float().numpy(), grads_want[k]
        if dtype == "f32":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-1 * np.abs(w).max() + 1e-6, rtol=0,
                                       err_msg=k)
    if dtype == "f32":
        mu, nu = _adam_moments(jnew.opt_state, params0)
        assert sorted(mu) == sorted(trainable)
        assert tstate.opt_state.count == 1
        for i, k in enumerate(trainable):
            np.testing.assert_allclose(tstate.opt_state.mu[i].numpy(), mu[k], atol=1e-7,
                                       rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(tstate.opt_state.nu[i].numpy(), nu[k], atol=1e-10,
                                       rtol=2e-4, err_msg=k)
    for k, p in tstate.params.items():
        p = p.detach().numpy()
        if k not in trainable:
            assert np.array_equal(p, before[k]), k  # frozen: the same bits
            assert np.array_equal(want[k], before[k]), k
            continue
        assert np.abs(want[k] - before[k]).max() > 0.5 * lr, k
        np.testing.assert_allclose(p, want[k], atol=2 * lr, rtol=0, err_msg=k)
        if dtype == "f32":
            sure = np.abs(grads_want[k]) > 1e-3 * np.abs(grads_want[k]).max()
            np.testing.assert_allclose(p[sure], want[k][sure], atol=1e-3 * lr, rtol=0,
                                       err_msg=k)


def test_chain_route_step_matches(params0, jax_grads):
    """``attn_impl="chain"`` runs the encoder as one chain (its plain
    version here): the same loss and gradients as the JAX flax path."""
    ref = jax_grads["f32"]
    t = _ttask("full", attn_impl="chain")
    tstate = t.init_state(0)
    interop.classifier_params_from_jax(params0, t.model)
    batch = _tbatch(_batch())
    images = t.preprocess_train(*ref["draws"], batch["image"])
    loss, sums = t.loss_and_metric_sums(images, batch, (), None)
    names = list(tstate.params)
    grads = torch.autograd.grad(loss, [tstate.params[k] for k in names])
    assert loss.item() == pytest.approx(ref["loss"], rel=1e-5)
    want = interop.classifier_params_to_state(ref["grads"])
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-6, rtol=1e-4, err_msg=k)


def test_classifier_eval_step_matches(params0):
    jt = _jtask("probe")
    batch = _batch(1)
    want = _np(jt.eval_step(jax.tree.map(jnp.asarray, params0), batch, jax.random.PRNGKey(3)))
    t = _ttask("probe")
    tstate = t.init_state(0)
    interop.classifier_params_from_jax(params0, t.model)
    got = t.eval_step(tstate, _tbatch(batch), None)
    assert set(got) == set(want)
    for k in ("acc_sum", "top5_sum", "weight_sum"):
        assert float(got[k]) == float(want[k]), k
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]), rel=1e-5)


MAE_MODEL = {"general": GENERAL, "encoder": ENCODER,
             "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4}}
MAE_CFG = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
           "total_epochs": 800, "warmup_epochs": 1, "batch_size": 4,
           "base_learning_rate": 1e-2, "weight_decay": 0.05}
JEPA_CFG = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": 4,
            "base_learning_rate": 1e-2, "weight_decay": 0.05,
            "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4,
            "num_target_blocks": 4, "target_scale": [0.15, 0.2],
            "target_aspect_ratio": [0.75, 1.5], "ema_start": 0.99, "ema_end": 1.0}


def test_mae_eval_step_matches():
    """The MAE eval step on ``eval_transform`` images, with the masks the
    JAX eval step draws from its rng."""
    jt = JMAETask(MAE_MODEL, MAE_CFG, dtype=jnp.float32)
    t = TMAETask(MAE_MODEL, MAE_CFG, dtype=torch.float32, device="cpu")
    params, _ = ti.mae_state_to_params(_port_state(t), depth=2, decoder_depth=1)
    tstate = t.init_state(0)
    ctx, rng, batch = jt.epoch_context(0), jax.random.PRNGKey(5), _batch(2)
    want = _np(jt.eval_step(params, batch, rng, ctx))
    keep, mask = random_token_mask(rng, B, jt.sequence_length, ctx)
    draws = (torch.from_numpy(np.array(keep)).long(), torch.from_numpy(np.array(mask)).long())
    got = t.eval_step(tstate, _tbatch(batch), None, ctx, draws=draws)
    assert set(got) == set(want)
    assert float(got["weight_sum"]) == float(want["weight_sum"])
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]), rel=1e-5)
    assert t.host_epoch_metrics(3) == JMAETask(MAE_MODEL, MAE_CFG).host_epoch_metrics(3)


def test_jepa_eval_step_matches():
    """The JEPA eval step: the EMA target of ``extra``, masks injected."""
    model = {"general": GENERAL, "encoder": ENCODER}
    jt = JJEPATask(model, JEPA_CFG, dtype=jnp.float32)
    t = TJEPATask(model, JEPA_CFG, dtype=torch.float32, device="cpu")
    state = _port_state(t)
    tstate = t.init_state(0)
    # the flax tree from the port's init, by the JAX package's own importers
    enc, _ = ti.timm_vit_to_params(ti.strip_prefix(state, "encoder."), 2)
    pred, _ = ti.lightly_decoder_to_params(ti.strip_prefix(state, "predictor."), 1)
    params = {"encoder": enc, "predictor": pred, "predictor_proj": {
        "kernel": state["predictor_proj.weight"].T, "bias": state["predictor_proj.bias"]}}
    extra = jax.tree.map(lambda a: a * 0.9, params["encoder"])
    rng, batch = jax.random.PRNGKey(6), _batch(3)
    want = _np(jt.eval_step(params, batch, rng, None, extra=extra))
    t_idx, c_idx = sample_jepa_masks(
        rng, B, jt.grid_size, jt.num_blocks, jt.block_area, jt.context_size, jt.aspect_range,
        context_sampling=jt.context_sampling, context_scale=jt.context_scale)
    interop.jepa_params_from_jax(_np(params), t.model)
    tstate.extra = {k: torch.from_numpy(v)
                    for k, v in interop.vit_params_to_state(_np(extra)).items()}
    draws = (torch.from_numpy(np.array(t_idx)).long(), torch.from_numpy(np.array(c_idx)).long())
    got = t.eval_step(tstate, _tbatch(batch), None, None, draws=draws)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k


@pytest.mark.parametrize("size", [96, 112])
def test_eval_transform_matches(size):
    """Normalize only at 96; at 112 the antialiased linear resize to 96 (a
    triangle kernel widened by 112/96), then the centre crop."""
    images = np.random.default_rng(size).integers(0, 256, (3, size, size, 3)).astype(np.uint8)
    want = np.asarray(j_eval_transform(images, out_size=96))
    got = t_eval_transform(torch.from_numpy(images), out_size=96).numpy()
    assert got.shape == want.shape == (3, 96, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_eval_transform_crops_the_long_side():
    images = np.random.default_rng(0).integers(0, 256, (2, 100, 130, 3)).astype(np.uint8)
    want = np.asarray(j_eval_transform(images, out_size=96))
    got = t_eval_transform(torch.from_numpy(images), out_size=96).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


SUMS = {"loss_sum": 7.5, "acc_sum": 2.0, "top5_sum": 3.0, "weight_sum": 3.5, "lr": 1e-3,
        "pred_std_sum": 1.25, "target_std_sum": 1.5, "cos_sum": 0.75, "ema_drift_sum": 0.125}


@pytest.mark.parametrize("task", ["classifier", "mae", "jepa"])
def test_epoch_metrics_from_sums_match(task):
    pairs = {"classifier": (TClassifierTask, JClassifierTask), "mae": (TMAETask, JMAETask),
             "jepa": (TJEPATask, JJEPATask)}
    tcls, jcls = pairs[task]
    for prefix in ("train", "val"):
        assert tcls.epoch_metrics_from_sums(SUMS, prefix) == jcls.epoch_metrics_from_sums(
            SUMS, prefix)
    assert tcls.epoch_metrics_from_sums({}, "val") == jcls.epoch_metrics_from_sums({}, "val")
