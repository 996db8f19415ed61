"""Checkpoint fidelity in the port, on the CPU, against the JAX package.

- ``parity_check``: the port's f32 models hold the golden torch forward on
  the stand-in checkpoints of ``tests/test_interop.py`` (as
  ``tests/test_parity_cli.py`` builds them), and equal the JAX flax models
  (``attn_impl="xla"``) within 1e-5 on the same weights, batch and
  JAX-drawn MAE mask; a loader patched to swap block 0's q and k rows
  fails the check.
- ``run_parity_protocol``: the port's probe re-evaluation against the JAX
  package's ``evaluate_probe_delta`` on a synthetic STL-10 test split.
- ``convert_torch_checkpoint``: the port writes the JAX CLI's
  ``state.msgpack`` and ``meta.json`` byte for byte, and the JAX
  ``load_checkpoint`` reads the port's file.
- The resume from a JAX-native trainer checkpoint
  (``utils/checkpoint.py::restore_native_state``): the committed
  classifier fixture and MAE, JEPA and linear-probe checkpoints written by
  the JAX ``Trainer.save``, with moments, count, rate, step and key set to
  seeded values first; params, moments and the EMA target equal bit for bit.

Geometry: ``tests/test_interop.py``'s (D=48, depth 2, 4 heads, 32 px; the
protocol at 96 px).
"""

import json
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from scripts.evaluation import run_parity_protocol as j_protocol
from scripts.weight_utils import convert_torch_checkpoint as j_convert
from ssrl_vit_mae_jepa_torch.config import load_config as t_load_config
from ssrl_vit_mae_jepa_torch.scripts.evaluation import parity_check as t_parity
from ssrl_vit_mae_jepa_torch.scripts.evaluation import run_parity_protocol as t_protocol
from ssrl_vit_mae_jepa_torch.scripts.weight_utils import convert_torch_checkpoint as t_convert
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask as TClassifierTask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.training.trainer import Trainer as TTrainer
from ssrl_vit_mae_jepa_torch.utils.interop import jepa_params_to_state
from ssrl_vit_mae_jepa_tpu.config import load_config as j_load_config
from ssrl_vit_mae_jepa_tpu.data.stl10 import write_synthetic_stl10
from ssrl_vit_mae_jepa_tpu.models import classifier_from_config, mae_from_config, vit_from_config
from ssrl_vit_mae_jepa_tpu.ops.masking import num_masked_tokens, random_token_mask
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.tasks import ClassifierTask as JClassifierTask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.training.trainer import Trainer as JTrainer
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti
from ssrl_vit_mae_jepa_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_interop import D, DEPTH, MODEL_CFG, P, make_mae_state, make_timm_state
from tests.test_torch_native_ckpt import FIXTURE, FIXTURE_MODEL

CFG = {"model": MODEL_CFG}
PORT_TOL = 1e-5  # the port's f32 forward against the flax model's, both on the CPU


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("SSRL_TORCH_DEVICE", "cpu")


def _save(state: dict, path):
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)
    return path


def _classifier_state(seed: int, img: int = 32) -> dict:
    state = {"encoder." + k: v for k, v in make_timm_state(seed, img=img).items()}
    r = np.random.default_rng(seed + 1)
    state["head.classification.weight"] = r.normal(0, 0.05, (10, D)).astype(np.float32)
    state["head.classification.bias"] = r.normal(0, 0.02, (10,)).astype(np.float32)
    return state


# --- parity_check ---------------------------------------------------------

STANDINS = {
    "encoder": lambda: {"model.encoder.vit." + k: v for k, v in make_timm_state(11).items()},
    "mae": lambda: make_mae_state(17),
    "classifier": lambda: _classifier_state(23),
}


def _x(batch: int = 2) -> np.ndarray:
    return np.random.default_rng(t_parity.BATCH_SEED).normal(
        0, 1, (batch, 3, 32, 32)).astype(np.float32)


def _jax_masks(batch: int = 2):
    L = (32 // P) ** 2 + 1
    keep, mask = random_token_mask(jax.random.PRNGKey(42), batch, L, num_masked_tokens(L, 0.75))
    return np.asarray(keep), np.asarray(mask)


@pytest.mark.parametrize("kind", list(STANDINS))
def test_check_file_passes_and_equals_the_flax_models(tmp_path, capsys, kind):
    state = STANDINS[kind]()
    ckpt = _save(state, tmp_path / f"{kind}.pt")
    masks = _jax_masks()
    assert t_parity.check_file(ckpt, CFG, batch=2, masks=masks)
    out = capsys.readouterr().out
    assert "🔬 encoder features: max abs err" in out and "✅ PARITY OK" in out
    assert ("🔬 MAE decoder pred:" in out) == (kind == "mae")
    assert ("🔬 classifier logits:" in out and "top-1 agreement 100.0%" in out) == (
        kind == "classifier")

    x, nhwc = _x(), jnp.asarray(_x().transpose(0, 2, 3, 1))
    enc, _ = t_parity.encoder_params_from_checkpoint(ckpt, DEPTH)
    params, report = ti.timm_vit_to_params(t_parity.encoder_state(state), DEPTH)
    assert not report["missing"]
    want = vit_from_config(MODEL_CFG, dtype=jnp.float32, attn_impl="xla").apply(
        {"params": params}, nhwc)
    np.testing.assert_allclose(t_parity.port_features(MODEL_CFG, enc, x, "cpu"),
                               np.asarray(want), rtol=0, atol=PORT_TOL)
    if kind == "mae":
        weights, _ = t_parity.mae_params_from_checkpoint(ckpt, DEPTH, 1)
        mae_params, _ = ti.mae_state_to_params(state, DEPTH, 1)
        pred, target = mae_from_config(MODEL_CFG, dtype=jnp.float32, attn_impl="xla").apply(
            {"params": mae_params}, nhwc, *masks)
        got_pred, got_target = t_parity.port_mae(MODEL_CFG, weights, x, *masks, "cpu")
        np.testing.assert_allclose(got_pred, np.asarray(pred), rtol=0, atol=PORT_TOL)
        np.testing.assert_array_equal(got_target, np.asarray(target))
    if kind == "classifier":
        weights, _, _ = t_parity.classifier_params_from_checkpoint(ckpt, DEPTH)
        clf_params, _ = ti.classifier_state_to_params(state, DEPTH)
        logits = classifier_from_config(MODEL_CFG, dtype=jnp.float32, attn_impl="xla").apply(
            {"params": clf_params}, nhwc)
        np.testing.assert_allclose(t_parity.port_logits(MODEL_CFG, weights, x, "cpu"),
                                   np.asarray(logits), rtol=0, atol=PORT_TOL)


def _swap_qk(load):
    """``load`` with the q and k rows of block 0's qkv weight swapped in
    what it returns: a loader fault that the file and the golden lack."""
    def patched(*args, **kwargs):
        out = load(*args, **kwargs)
        state = out[0]
        key = next(k for k in state if k.endswith("blocks.0.attn.qkv.weight"))
        w = state[key].clone()
        n = w.shape[0] // 3
        w[:n], w[n:2 * n] = state[key][n:2 * n], state[key][:n]
        state[key] = w
        return out
    return patched


@pytest.mark.parametrize("kind", ["encoder", "classifier"])
def test_a_loader_that_swaps_q_and_k_fails_the_check(tmp_path, capsys, monkeypatch, kind):
    ckpt = _save(STANDINS[kind](), tmp_path / f"{kind}.pt")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(CFG))
    argv = [str(ckpt), "--config", str(cfg_path), "--batch", "2"]
    assert t_parity.main(argv)
    assert "✅ PARITY OK" in capsys.readouterr().out
    for name in ("encoder_params_from_checkpoint", "classifier_params_from_checkpoint"):
        monkeypatch.setattr(t_parity, name, _swap_qk(getattr(t_parity, name)))
    with pytest.raises(SystemExit) as exit_:
        t_parity.main(argv)
    assert exit_.value.code == 1
    assert "❌ PARITY FAILED" in capsys.readouterr().out


# --- run_parity_protocol --------------------------------------------------

def test_protocol_matches_the_jax_probe_delta(tmp_path, capsys):
    data = tmp_path / "data"
    write_synthetic_stl10(data, num_train=20, num_test=30, num_unlabeled=20, seed=3)
    cfg = {"model": {**MODEL_CFG, "general": {**MODEL_CFG["general"], "image_size": 96}},
           "train": {"samples_per_class": 2, "total_epochs": 1, "warmup_epochs": 1,
                     "batch_size": 16, "learning_rate": 1e-3, "weight_decay": 0.05,
                     "freeze_encoder": True},
           "test": {"batch_size": 16},
           "logging": {"output_dir_base": str(tmp_path / "outputs"), "model_path": "vit-mae.pt"}}
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    weights = tmp_path / "weights"
    weights.mkdir()
    _save(make_mae_state(31, img=96), weights / "vit-mae.pt")
    probe = _save(_classifier_state(32, img=96), weights / "mae_100_400.pt")

    rows = t_protocol.main([str(weights), "--config", str(cfg_path), "--batch", "2",
                            "--data-dir", str(data)])
    out = capsys.readouterr().out
    assert "MAE decoder pred" in out and "probe top-1" in out and "✅ PROTOCOL OK" in out
    assert [r["file"] for r in rows] == ["mae_100_400.pt", "vit-mae.pt"]
    assert all(r["golden"] for r in rows) and rows[0]["within_bar"]

    ours, golden = t_protocol.evaluate_probe_delta(probe, t_load_config(cfg_path), data)
    j_ours, j_golden = j_protocol.evaluate_probe_delta(probe, j_load_config(cfg_path), data)
    assert golden == j_golden
    # both evaluate in bf16, each by its own kernels: one test image of 30 at most
    assert abs(ours - j_ours) <= 1 / 30 + 1e-12


# --- convert_torch_checkpoint ---------------------------------------------

CONVERT = {
    "mae": lambda: make_mae_state(41),
    "classifier": lambda: _classifier_state(43),
    "encoder": lambda: {"state_dict": {"model.encoder.vit." + k: torch.from_numpy(v)
                                       for k, v in make_timm_state(47).items()}},
}


def _entries(path) -> dict:
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("kind", list(CONVERT))
def test_converter_writes_the_jax_clis_bytes(tmp_path, monkeypatch, kind):
    src = tmp_path / f"{kind}.pt"
    state = CONVERT[kind]()
    torch.save(state, src) if kind == "encoder" else _save(state, src)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    args = ["--depth", str(DEPTH), "--decoder_depth", "1"]
    assert t_convert.main([str(src), str(tmp_path / "port" / "w.ckpt"), *args]) == kind
    monkeypatch.setattr(sys, "argv", ["convert", str(src), str(tmp_path / "jax" / "w.ckpt"),
                                      *args])
    j_convert.main()
    port, want = _entries(tmp_path / "port" / "w.ckpt"), _entries(tmp_path / "jax" / "w.ckpt")
    assert list(port) == list(want) == ["state.msgpack", "meta.json"]
    assert port["state.msgpack"] == want["state.msgpack"]
    assert port["meta.json"] == want["meta.json"]
    assert json.loads(port["meta.json"])["kind"] == f"{kind}_weights"
    got, meta = load_checkpoint(tmp_path / "port" / "w.ckpt")
    ref, _ = load_checkpoint(tmp_path / "jax" / "w.ckpt")
    assert meta["converted_from"] == str(src)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)))


# --- resume from a JAX-native trainer checkpoint --------------------------

MODEL = {**MODEL_CFG, "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1,
                                  "decoder_num_heads": 4}}
PRE_CFG = {"batch_size": 8, "total_epochs": 4, "warmup_epochs": 1}
JEPA_CFG = {"batch_size": 8, "total_epochs": 4, "warmup_epochs": 1, "predictor_embed_dim": 32,
            "predictor_depth": 1, "predictor_num_heads": 4}
META = {"epoch": 2, "global_step": 17, "callbacks": {"best_model_score": 0.25}}
RESUME = {
    # JAX task, port task, the Adam node's path in opt_state, the JAX export
    "mae": (lambda: JMAETask(MODEL, PRE_CFG, dtype=jnp.float32),
            lambda: TMAETask(MODEL, PRE_CFG, dtype=torch.float32, device="cpu"),
            ("inner_state", "1", "0"), ti.mae_params_to_state),
    "jepa": (lambda: JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32),
             lambda: TJEPATask(MODEL, JEPA_CFG, dtype=torch.float32, device="cpu"),
             ("inner_state", "1", "0"), jepa_params_to_state),
    "probe": (lambda: JClassifierTask(MODEL, {"freeze_encoder": True}, dtype=jnp.float32),
              lambda: TClassifierTask(MODEL, {"freeze_encoder": True}, dtype=torch.float32,
                                      device="cpu"),
              ("inner_state", "inner_state", "1", "0"), ti.classifier_params_to_state),
}


def _with_history(state, seed: int):
    """The JAX state with seeded moments, count, rate, step, key and (JEPA)
    EMA target, so that none of them is its initial value."""
    r = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return jnp.asarray((np.abs(r.normal(size=x.shape)) * 1e-3).astype(x.dtype))
        return jnp.asarray(np.full(x.shape, 7, x.dtype))

    extra = None if state.extra is None else jax.tree.map(lambda t: t * 0.5 + 0.01, state.extra)
    return state.replace(opt_state=jax.tree.map(fill, state.opt_state),
                         step=jnp.asarray(11, jnp.int32), rng=jax.random.PRNGKey(seed + 100),
                         extra=extra)


def _zero_frozen(params, moment):
    """A restored moment tree with each frozen leaf (``MaskedNode``, an
    empty map) as zeros of its parameter's shape."""
    if isinstance(params, dict):
        return {k: _zero_frozen(v, moment[k]) for k, v in params.items()}
    return np.zeros_like(params) if isinstance(moment, dict) else moment


def _check_resumed(path, task, adam_path, export):
    """Resume ``task`` from ``path`` and hold it to the file as flax reads it."""
    with zipfile.ZipFile(path) as zf:
        raw = serialization.msgpack_restore(zf.read("state.msgpack"))
        meta = json.loads(zf.read("meta.json"))
    trainer = TTrainer(task, 9, path.parent / "port_out")
    trainer.init_state()
    assert trainer._resume(path) == meta["epoch"] + 1
    assert trainer.global_step == meta["global_step"]
    assert trainer.callbacks.best_score == meta.get("callbacks", {}).get("best_model_score")
    state = trainer.state

    def same(got: dict, want: dict, names):
        for k in names:
            g, w = got[k].detach(), torch.from_numpy(np.asarray(want[k]))
            assert g.dtype == w.dtype and torch.equal(g, w), k

    model_state = task.model.state_dict()
    same(model_state, export(raw["params"]), model_state)
    adam = raw["opt_state"]
    for p in adam_path:
        adam = adam[p]
    names = task.tx.trainable(state.params)
    for key, tensors in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        same(dict(zip(names, tensors)), export(_zero_frozen(raw["params"], adam[key])), names)
    assert int(state.opt_state.count) == int(adam["count"])
    assert torch.equal(state.opt_state.learning_rate,
                       torch.from_numpy(raw["opt_state"]["hyperparams"]["learning_rate"]))
    assert state.step == int(raw["step"])
    w0, w1 = (int(w) for w in raw["rng"])
    assert torch.equal(state.generator.get_state(),
                       torch.Generator().manual_seed((w0 << 32) | w1).get_state())
    if raw["extra"] is not None:
        same(state.extra, ti.vit_params_to_timm_state(raw["extra"]), state.extra)
    return trainer


@pytest.mark.parametrize("kind", list(RESUME))
def test_resume_from_a_jax_trainer_checkpoint(tmp_path, kind):
    make_jax, make_port, adam_path, export = RESUME[kind]
    jt = JTrainer(make_jax(), 9, tmp_path / "jax_out")
    jt.state = _with_history(make_jax().init_state(jax.random.PRNGKey(3)), 5)
    path = jt.save(tmp_path / f"{kind}.ckpt", dict(META))
    trainer = _check_resumed(path, make_port(), adam_path, export)
    assert trainer.state.step == 11 and int(trainer.state.opt_state.count) == 7
    if kind == "probe":  # the MaskedNode leaves: only the head trains
        assert trainer.task.tx.trainable(trainer.state.params) == [
            "head.classification.weight", "head.classification.bias"]


def test_resume_from_the_committed_fixture(tmp_path):
    import shutil

    # a copy: the trainer writes its logs beside the checkpoint
    path = shutil.copy(FIXTURE, tmp_path / FIXTURE.name)
    task = TClassifierTask(FIXTURE_MODEL, {"freeze_encoder": False}, dtype=torch.float32,
                           device="cpu")
    _check_resumed(path, task, ("inner_state", "inner_state", "1", "0"),
                   ti.classifier_params_to_state)


def test_resume_refuses_a_weights_only_file_and_other_frozen_sets(tmp_path):
    jt = JClassifierTask(MODEL, {"freeze_encoder": True}, dtype=jnp.float32)
    state = jt.init_state(jax.random.PRNGKey(0))
    weights = save_checkpoint(tmp_path / "w.ckpt", {"params": state.params},
                              {"kind": "classifier_weights"})
    probe = save_checkpoint(tmp_path / "probe.ckpt", state, dict(META))
    port = TTrainer(TClassifierTask(MODEL, {"freeze_encoder": True}, dtype=torch.float32,
                                    device="cpu"), 9, tmp_path / "out")
    port.init_state()
    with pytest.raises(ValueError, match="weights-only checkpoint cannot resume"):
        port._resume(weights)
    full = TTrainer(TClassifierTask(MODEL, {"freeze_encoder": False}, dtype=torch.float32,
                                    device="cpu"), 9, tmp_path / "out2")
    full.init_state()
    with pytest.raises(ValueError, match="covers 2 tensors, the task trains 32"):
        full._resume(probe)
