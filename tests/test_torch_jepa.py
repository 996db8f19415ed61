"""The JEPA slice of the port against the JAX package on the CPU: masking,
the parameter converter, the EMA schedule and whole ``JEPATask`` steps.

Geometry: ``tests/test_jepa.py``'s SMALL_MODEL (96 px, patch 8, encoder
48/2/4) and a predictor 32/1/4, B=4. Both sides run in f32 (the JAX side
off the TPU takes the flax path); the port is built from the same params
through ``jepa_params_from_jax``. JAX's draws are reproduced as
``Task._local_train_step`` makes them (``split(state.rng, 3)``, then
``draw_augment_params``, then ``sample_jepa_masks``) and injected. The EMA
target starts perturbed away from the context encoder, so that the target
tower and the drift are tested with weights of their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.ops import jepa_masking as tm
from ssrl_vit_mae_jepa_torch.training import schedules as tsched
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.utils.interop import (
    jepa_params_from_jax,
    jepa_params_to_state,
    vit_params_to_state,
)
from ssrl_vit_mae_jepa_tpu.ops import jepa_masking as jm
from ssrl_vit_mae_jepa_tpu.ops.augment import apply_augment_patches, draw_augment_params
from ssrl_vit_mae_jepa_tpu.training import schedules as jsched
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask

MODEL = {
    "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
    "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
}
# warmup 1 and a large base LR, so that one step moves every param by ~lr
JEPA_CFG = {
    "total_epochs": 4, "warmup_epochs": 1, "batch_size": 4,
    "base_learning_rate": 1e-2, "weight_decay": 0.05,
    "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4,
    "num_target_blocks": 4, "target_scale": [0.15, 0.2],
    "target_aspect_ratio": [0.75, 1.5], "ema_start": 0.99, "ema_end": 1.0,
}
B = 4
GRID = 12


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


# --------------------------------------------------------------------------
# masking
# --------------------------------------------------------------------------


@pytest.mark.parametrize("area,aspect", [(24, (0.75, 1.5)), (25, (0.75, 1.5)),
                                         (7, (0.75, 1.5)), (36, (0.5, 2.0)), (4, (1.0, 1.0))])
def test_block_shapes_match_the_jax_package(area, aspect):
    assert tm.block_shapes_for(area, aspect) == jm.block_shapes_for(area, aspect)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_mask_invariants():
    t_idx, c_idx = tm.sample_jepa_masks(_gen(), 8, GRID, 4, 24, 48)
    assert t_idx.shape == (8, 96) and c_idx.shape == (8, 48)
    assert t_idx.dtype == c_idx.dtype == torch.int64
    t, c = t_idx.numpy(), c_idx.numpy()
    assert t.min() >= 0 and t.max() < 144 and c.min() >= 0 and c.max() < 144
    for b in range(8):
        assert not set(c[b]) & set(t[b])  # the context avoids every target
        assert len(set(c[b])) == 48


def test_blocks_are_rectangles_of_the_area():
    t_idx, _ = tm.sample_jepa_masks(_gen(1), 16, GRID, 3, 24, 48)
    t = t_idx.numpy().reshape(16, 3, 24)
    for blk in t.reshape(-1, 24):
        assert len(set(blk)) == 24
        ys, xs = blk // GRID, blk % GRID
        assert (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1) == 24


def test_block_context_sampling():
    """'block': the context is a square block minus the targets (the block
    always holds enough: side 8, 64 cells, at most 4 targets)."""
    t_idx, c_idx = tm.sample_jepa_masks(_gen(2), 8, GRID, 1, 4, 48,
                                        context_sampling="block", context_scale=(0.5, 0.5))
    t, c = t_idx.numpy(), c_idx.numpy()
    side = int(np.floor(GRID * np.sqrt(0.5)))
    for b in range(8):
        assert not set(c[b]) & set(t[b]) and len(set(c[b])) == 48
        ys, xs = c[b] // GRID, c[b] % GRID
        assert ys.max() - ys.min() + 1 <= side and xs.max() - xs.min() + 1 <= side


def test_block_context_fills_from_outside_when_needed():
    t_idx, c_idx = tm.sample_jepa_masks(_gen(3), 4, GRID, 1, 4, 20,
                                        context_sampling="block", context_scale=(0.1, 0.1))
    t, c = t_idx.numpy(), c_idx.numpy()
    for b in range(4):
        assert not set(c[b]) & set(t[b]) and len(set(c[b])) == 20


def test_context_comes_in_priority_order_and_blocks_overlap():
    """The context indices are argsort order (unsorted), and overlapping
    target blocks repeat indices: the static contract, not a sorted set."""
    t_idx, c_idx = tm.sample_jepa_masks(_gen(4), 64, GRID, 4, 25, 44)
    c = c_idx.numpy()
    assert any((np.diff(row) < 0).any() for row in c)
    assert any(len(set(row)) < 100 for row in t_idx.numpy())


def test_unknown_context_sampling_rejected():
    with pytest.raises(ValueError, match="context_sampling"):
        tm.sample_jepa_masks(_gen(), 2, GRID, 1, 4, 8, context_sampling="nope")


def test_task_geometry_matches_the_jax_task():
    j = JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32)
    t = TJEPATask(MODEL, JEPA_CFG, dtype=torch.float32, device="cpu")
    for name in ("grid_size", "num_patches", "num_blocks", "block_area", "aspect_range",
                 "context_size", "context_sampling", "context_scale", "base_lr"):
        assert getattr(t, name) == getattr(j, name), name
    t_idx, c_idx = t.draw_task(_gen(), B, None)
    assert t_idx.shape == (B, t.num_blocks * t.block_area) and c_idx.shape == (B, t.context_size)


# --------------------------------------------------------------------------
# task surface, EMA schedule
# --------------------------------------------------------------------------


def test_task_runs_on_the_card_unless_told_otherwise():
    assert TJEPATask(MODEL, JEPA_CFG).device == torch.device("cuda")
    assert TJEPATask(MODEL, JEPA_CFG, device="cpu").device == torch.device("cpu")


def test_unported_options_raise(monkeypatch):
    """The two options this test once saw refused, the un-augmented path and
    the dense loss, are routes now: the task takes them and draws no
    augmentation when it is off (``tests/test_torch_lineage.py`` holds their
    steps to the JAX task's)."""
    t = TJEPATask(MODEL, {**JEPA_CFG, "augment": False}, device="cpu")
    assert not t.augment and not t.dense_loss
    gen = _gen()
    u, flip, t_idx, c_idx = t.draw(gen, B, None)
    assert u is None and flip is None
    want = t.draw_task(_gen(), B, None)
    assert torch.equal(t_idx, want[0]) and torch.equal(c_idx, want[1])
    monkeypatch.setenv("SSRL_JEPA_DENSE_LOSS", "1")
    assert TJEPATask(MODEL, JEPA_CFG, device="cpu").dense_loss


@pytest.mark.parametrize("step,total", [(0, 40), (1, 40), (7, 40), (39, 40), (41, 40),
                                        (123, 1_000_000), (5, 0)])
def test_ema_momentum_matches_the_jax_schedule(step, total):
    want = float(jsched.ema_momentum_at_step(step, total, 0.996, 1.0))
    assert tsched.ema_momentum_at_step(step, total, 0.996, 1.0) == want


def test_host_metrics_and_epoch_sums_match():
    j = JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32)
    t = TJEPATask(MODEL, JEPA_CFG, dtype=torch.float32, device="cpu")
    assert t.host_epoch_metrics(2) == pytest.approx(j.host_epoch_metrics(2))
    for task in (j, t):
        task.on_fit_start(steps_per_epoch=10)
    assert t.host_epoch_metrics(2) == pytest.approx(j.host_epoch_metrics(2), rel=1e-7)
    sums = {"loss_sum": 3.0, "weight_sum": 2.0, "pred_std_sum": 1.0, "cos_sum": 0.5,
            "ema_drift_sum": 0.25}
    assert t.epoch_metrics_from_sums(sums, "train") == j.epoch_metrics_from_sums(sums, "train")


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return _np_tree(JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0)))


def _flatten_by_rule(tree, in_chans=3):
    """An independent flatten of a flax JEPA tree into torch names: '/' to
    '.', ``blocks_i`` to ``blocks.i``, scale/kernel to weight (kernels
    transposed; the patch embedding under ``proj``, its kernel to
    (D, C, p, p))."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[-2:] == ["patch_embed", "bias"]:
            keys = keys[:-1] + ["proj", "bias"]
        elif keys[-2:] == ["patch_embed", "kernel"]:
            pc, D = v.shape
            p = int(round((pc // in_chans) ** 0.5))
            keys = keys[:-1] + ["proj", "weight"]
            v = v.T.reshape(D, in_chans, p, p)
        elif keys[-1] == "kernel":
            keys, v = keys[:-1] + ["weight"], v.T
        elif keys[-1] == "scale":
            keys = keys[:-1] + ["weight"]
        name = ".".join(keys)
        for blocks in ("decoder_blocks", "blocks"):
            name = name.replace(f"{blocks}_", f"{blocks}.")
        out[name] = np.ascontiguousarray(v)
    return out


def test_export_equals_a_flatten_of_the_jax_tree(jparams):
    assert "decoder_pred" not in jparams["predictor"]
    mine = jepa_params_to_state(jparams)
    want = _flatten_by_rule(jparams)
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        assert mine[k].dtype == np.float32 and mine[k].shape == v.shape, k
        assert np.array_equal(mine[k], v), k


def test_converter_loads_strict(jparams):
    task = TJEPATask(MODEL, JEPA_CFG, dtype=torch.float32, device="cpu")
    jepa_params_from_jax(jparams, task.model)
    state = task.model.state_dict()
    for k, v in jepa_params_to_state(jparams).items():
        assert np.array_equal(state[k].numpy(), v), k
    extra = vit_params_to_state(jparams["encoder"])
    assert set(extra) == {k[len("encoder."):] for k in state if k.startswith("encoder.")}


# --------------------------------------------------------------------------
# the JEPA step
# --------------------------------------------------------------------------


def _make(sampling, fit_start):
    cfg = {**JEPA_CFG, "context_sampling": sampling}
    jtask = JJEPATask(MODEL, cfg, dtype=jnp.float32)
    jstate = jtask.init_state(jax.random.PRNGKey(0))
    noise = jax.random.split(jax.random.PRNGKey(7), len(jax.tree.leaves(jstate.extra)))
    leaves, tdef = jax.tree.flatten(jstate.extra)
    extra = [a + 0.02 * jax.random.normal(k, a.shape) for a, k in zip(leaves, noise)]
    jstate = jstate.replace(extra=jax.tree.unflatten(tdef, extra))
    ttask = TJEPATask(MODEL, cfg, dtype=torch.float32, device="cpu")
    tstate = ttask.init_state(0)
    jepa_params_from_jax(_np_tree(jstate.params), ttask.model)
    tstate.extra = {k: torch.from_numpy(v)
                    for k, v in vit_params_to_state(_np_tree(jstate.extra)).items()}
    if fit_start:
        jtask.on_fit_start(steps_per_epoch=10)
        ttask.on_fit_start(steps_per_epoch=10)
    images = np.random.default_rng(0).integers(0, 256, (B, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(B, np.int32),
             "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, B)
    t_idx, c_idx = jm.sample_jepa_masks(
        task_rng, B, jtask.grid_size, jtask.num_blocks, jtask.block_area,
        jtask.context_size, jtask.aspect_range, context_sampling=jtask.context_sampling,
        context_scale=jtask.context_scale)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (u, flip, t_idx, c_idx))
    draws = draws[:2] + tuple(d.long() for d in draws[2:])
    tbatch = {"image": torch.from_numpy(images), "weight": torch.from_numpy(batch["weight"])}
    return dict(jtask=jtask, jstate=jstate, batch=batch, task_rng=task_rng, u=u, flip=flip,
                images=images, ttask=ttask, tstate=tstate, draws=draws, tbatch=tbatch)


@pytest.fixture(scope="module")
def complement():
    return _make("complement", fit_start=False)


def test_loss_gradients_and_sums_match(complement):
    s = complement
    jtask, jstate = s["jtask"], s["jstate"]
    jimages = apply_augment_patches(s["u"], s["flip"], s["images"], patch_size=8, out_size=96)

    def loss_fn(p):
        return jtask.loss_and_metric_sums_in_step(p, jstate, jimages, s["batch"],
                                                  s["task_rng"], None)

    (jloss, jsums), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    t, st = s["ttask"], s["tstate"]
    u, flip, *task_draws = s["draws"]
    images = t.preprocess_train(u, flip, s["tbatch"]["image"])
    loss, sums = t.loss_and_metric_sums_in_step(st, images, s["tbatch"], task_draws, None)
    names = list(st.params)
    grads = torch.autograd.grad(loss, [st.params[n] for n in names])
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert set(sums) == set(jsums)
    for k, v in jsums.items():
        assert float(sums[k].detach()) == pytest.approx(float(v), rel=1e-5), k
    assert float(jsums["ema_drift_sum"]) > 0
    want = jepa_params_to_state(_np_tree(jgrads))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-6, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("sampling,fit_start", [("complement", False), ("block", True)])
def test_train_step_matches(complement, sampling, fit_start):
    """A whole step (augment, masks, loss, grads, clip, AdamW, EMA) from the
    same state and draws at epoch 1. Params within 2·lr of the JAX step's
    (Adam's first step is ±lr per element; near-zero gradients may differ
    in sign). The EMA is exact on the port's own params (atol 1e-7) and
    within 2·lr·(1 - m) + 1e-6 of JAX's, the params' tolerance carried
    through the EMA. Covers both momentum paths (per epoch, and per step
    after ``on_fit_start``) and both context samplers."""
    s = complement if (sampling, fit_start) == ("complement", False) else _make(sampling, fit_start)
    jnew, jsums = s["jtask"].train_step(jax.tree.map(jnp.array, s["jstate"]), s["batch"], 1, None)
    t, st = s["ttask"], s["tstate"]
    params0 = {k: v.detach().clone() for k, v in st.params.items()}
    extra0 = {k: v.clone() for k, v in st.extra.items()}
    st, tsums = t.train_step(st, s["tbatch"], 1, None, draws=s["draws"])
    lr = tsums["lr"]
    assert lr == pytest.approx(float(jsums["lr"]), rel=1e-6)
    assert st.step == 1
    for k in ("loss_sum", "weight_sum", "pred_std_sum", "target_std_sum", "cos_sum",
              "ema_drift_sum"):
        assert float(tsums[k]) == pytest.approx(float(jsums[k]), rel=1e-5), k
    want = jepa_params_to_state(_np_tree(jnew.params))
    for name, p in st.params.items():
        assert np.abs(want[name] - params0[name].numpy()).max() > 0.5 * lr, name
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2 * lr, rtol=0,
                                   err_msg=name)
    m = t._momentum(st, 1)
    assert m == pytest.approx(0.99 + 0.01 * (1 / 40 if fit_start else 1 / 4), rel=1e-6)
    want_extra = vit_params_to_state(_np_tree(jnew.extra))
    assert set(st.extra) == set(want_extra)
    for k, v in st.extra.items():
        mine = extra0[k] * m + st.params["encoder." + k].detach() * (1 - m)
        torch.testing.assert_close(v, mine, atol=1e-7, rtol=0)
        np.testing.assert_allclose(v.numpy(), want_extra[k], atol=2 * lr * (1 - m) + 1e-6,
                                   rtol=0, err_msg=k)


def test_bf16_loss_close(complement):
    """The default bf16 model on both sides: the JAX flax path and the
    port's plain branch versions round at other points, so the loss is
    held to rtol 2e-2 (chip_smoke's card-vs-CPU tolerance)."""
    s = complement
    jtask = JJEPATask(MODEL, JEPA_CFG)
    jimages = apply_augment_patches(s["u"], s["flip"], s["images"], patch_size=8, out_size=96)
    jloss, _ = jax.jit(lambda p, e: jtask.loss_and_metric_sums(
        p, jimages, s["batch"], s["task_rng"], None, extra=e))(
        s["jstate"].params, s["jstate"].extra)
    t = TJEPATask(MODEL, JEPA_CFG, device="cpu")
    st = t.init_state(0)
    jepa_params_from_jax(_np_tree(s["jstate"].params), t.model)
    extra = {k: torch.from_numpy(v) for k, v in vit_params_to_state(_np_tree(s["jstate"].extra)).items()}
    u, flip, *task_draws = s["draws"]
    with torch.no_grad():
        loss, _ = t.loss_and_metric_sums(t.preprocess_train(u, flip, s["tbatch"]["image"]),
                                         s["tbatch"], task_draws, None, extra=extra)
    assert st.params  # the state was built
    assert loss.item() == pytest.approx(float(jloss), rel=2e-2)
