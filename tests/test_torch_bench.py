"""The port's bench slice against the JAX package, on the CPU.

``utils/flops.py`` against the JAX one (the exact integers), the peak
table, AdamW with its step count and rate as device tensors against optax,
JEPA's device-side EMA momentum against the JAX f32 value,
``train_steps_fused`` on the CPU against the same number of
``train_step``s bit for bit, a checkpoint round trip of the tensor count
and rate, and ``bench.main`` at ``--tiny`` printing the JAX bench's keys.
In process, toy widths: a few seconds in all.
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssrl_vit_mae_jepa_torch import bench
from ssrl_vit_mae_jepa_torch.config import DEFAULTS
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.optim import make_optimizer, set_learning_rate
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask as TClassifierTask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils import checkpoint as t_ckpt
from ssrl_vit_mae_jepa_torch.utils import flops as t_flops
from ssrl_vit_mae_jepa_tpu.training import optim as j_optim
from ssrl_vit_mae_jepa_tpu.training import schedules as j_sched
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.tasks import ClassifierTask as JClassifierTask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils import flops as j_flops

REPO = pathlib.Path(__file__).resolve().parents[1]
PRE_CFG = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
           "total_epochs": 800, "warmup_epochs": 20, "batch_size": 768,
           "base_learning_rate": 1.5e-4, "weight_decay": 0.05}
# freeze policy -> (freeze_encoder, unfreeze_last_layers)
POLICIES = {"full": (False, None), "probe": (True, None), "unfreeze2": (False, 2)}
CONFIGS = {"flagship": (DEFAULTS["model"], DEFAULTS["jepa"]),
           "tiny": (bench.TINY_MODEL, {**DEFAULTS["jepa"], **bench.TINY_JEPA})}


def _tasks(kind, config, policy="full"):
    model, jepa = CONFIGS[config]
    if kind == "mae":
        return (TMAETask(model, PRE_CFG, device="cpu"), JMAETask(model, PRE_CFG))
    if kind == "jepa":
        cfg = {**jepa, "batch_size": 768}
        return TJEPATask(model, cfg, device="cpu"), JJEPATask(model, cfg)
    freeze, unfreeze = POLICIES[policy]
    cfg = {**DEFAULTS["train"], "freeze_encoder": freeze, "unfreeze_last_layers": unfreeze}
    return TClassifierTask(model, cfg, device="cpu"), JClassifierTask(model, cfg)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind,policy", [("mae", "full"), ("jepa", "full"),
                                         *(("classifier", p) for p in POLICIES)])
def test_flops_per_image_equal_the_jax_count(config, kind, policy):
    t, j = _tasks(kind, config, policy)
    for epoch in (0, 3):
        want = j_flops.task_flops_per_image(j, j.epoch_context(epoch))
        got = t_flops.task_flops_per_image(t, t.epoch_context(epoch))
        assert type(got) is int and got == want
    assert t_flops.task_flops_per_image(t) == j_flops.task_flops_per_image(j)


def test_flagship_flops_per_image():
    """The flagship step's MFLOP per image: MAE, JEPA, the full fine-tune."""
    got = [round(t_flops.task_flops_per_image(_tasks(k, "flagship")[0]) / 1e6)
           for k in ("mae", "jepa", "classifier")]
    assert got == [1151, 905, 1035]


def test_peak_flops_per_chip(monkeypatch):
    monkeypatch.delenv("SSRL_PEAK_TFLOPS", raising=False)
    assert t_flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert t_flops.peak_flops_per_chip("Some Other Card") is None
    assert t_flops.peak_flops_per_chip("cpu") is None
    monkeypatch.setenv("SSRL_PEAK_TFLOPS", "123.5")
    assert t_flops.peak_flops_per_chip("Some Other Card") == 123.5e12
    assert t_flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 123.5e12


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_adamw_with_tensor_count_and_rate_matches_optax(scale):
    """Three steps with other gradients and rates each: the params, the
    moments and the count against optax's ``inject_hyperparams`` AdamW at
    atol 1e-6; the large scale forces the global-norm clip."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lrs = [3e-3, 1e-3, 2e-2]

    jtx = j_optim.make_optimizer(1e-4, 0.05, 1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ttx = make_optimizer(1e-4, 0.05, 1.0)
    tstate = ttx.init(tp)
    assert tstate.count.dtype == torch.int32 and tstate.learning_rate.dtype == torch.float32
    assert tstate.count.shape == tstate.learning_rate.shape == ()
    for g, lr in zip(grads, lrs):
        jstate = j_optim.set_learning_rate(jstate, lr)
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        set_learning_rate(tstate, lr)
        ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
    adam = jstate.inner_state[1][0]
    assert int(tstate.count) == int(adam.count) == 3
    assert float(tstate.learning_rate) == np.float32(lrs[-1])
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tstate.mu[i].numpy(), np.asarray(adam.mu[k]), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(tstate.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=1e-5)


TOY = {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
       "encoder": {"embed_dim": 32, "depth": 2, "num_heads": 4},
       "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
       "head": {"pool": "cls"}}
TOY_JEPA = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": 4,
            "base_learning_rate": 1e-3, "predictor_embed_dim": 32, "predictor_depth": 1,
            "predictor_num_heads": 4, "ema_start": 0.99, "ema_end": 1.0}
TOY_PRE = {**PRE_CFG, "batch_size": 4, "total_epochs": 4, "warmup_epochs": 1}
TOY_TRAIN = {"learning_rate": 1e-3, "total_epochs": 4, "warmup_epochs": 1,
             "freeze_encoder": False}


def _toy_task(kind):
    if kind == "mae":
        return TMAETask(TOY, TOY_PRE, dtype=torch.float32, device="cpu")
    if kind == "jepa":
        return TJEPATask(TOY, TOY_JEPA, dtype=torch.float32, device="cpu")
    return TClassifierTask(TOY, TOY_TRAIN, dtype=torch.float32, device="cpu")


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 10, n).astype(np.int32)),
            "weight": torch.ones(n)}


@pytest.mark.parametrize("fit_start", [False, True], ids=["per-epoch", "per-step"])
def test_jepa_momentum_on_the_device_equals_the_jax_value(fit_start):
    """After 5 steps the momentum comes from the optimizer's count (5), a
    0-d f32 tensor equal to the JAX package's f32 value."""
    task = _toy_task("jepa")
    if fit_start:
        task.on_fit_start(steps_per_epoch=3)
    state = task.init_state(0)
    for _ in range(5):
        state, _ = task.train_step(state, _batch(), 1)
    assert int(state.opt_state.count) == state.step == 5
    m = task._momentum(state, 1)
    assert m.dtype == torch.float32 and m.shape == ()
    j = JJEPATask(TOY, TOY_JEPA, dtype=jnp.float32)
    if fit_start:
        j.on_fit_start(steps_per_epoch=3)
        want = j_sched.ema_momentum_at_step(5, j.total_steps, j.ema_start, j.ema_end)
    else:
        want = j._momentum(None, 1)
    assert float(m) == float(np.float32(want))


def _snapshot(state):
    opt = state.opt_state
    out = {f"p.{k}": v.detach().clone() for k, v in state.params.items()}
    out.update({f"mu.{i}": t.clone() for i, t in enumerate(opt.mu)})
    out.update({f"nu.{i}": t.clone() for i, t in enumerate(opt.nu)})
    out.update({f"ema.{k}": v.clone() for k, v in (state.extra or {}).items()})
    out["count"], out["lr"] = opt.count.clone(), opt.learning_rate.clone()
    out["generator"] = state.generator.get_state()
    return out


@pytest.mark.parametrize("kind", ["mae", "jepa", "classifier"])
def test_fused_steps_on_the_cpu_equal_the_steps(kind):
    """``train_steps_fused(n=3)`` on the CPU is three ``train_step``s: the
    same params, moments, count, EMA, generator state and last sums, bit
    for bit."""
    runs = []
    for fused in (False, True):
        task = _toy_task(kind)
        state = task.init_state(0)
        if fused:
            state, sums = task.train_steps_fused(state, _batch(), 1, task.epoch_context(1), 3)
        else:
            for _ in range(3):
                state, sums = task.train_step(state, _batch(), 1, task.epoch_context(1))
        assert state.step == 3 and int(state.opt_state.count) == 3
        runs.append((_snapshot(state), sums))
    (a, sa), (b, sb) = runs
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert sa.keys() == sb.keys() and sa["lr"] == sb["lr"]
    assert all(torch.equal(sa[k], sb[k]) for k in sa if k != "lr")


def test_fused_steps_need_a_positive_count():
    task = _toy_task("mae")
    state = task.init_state(0)
    with pytest.raises(ValueError, match="at least 1"):
        task.train_steps_fused(state, _batch(), 0, task.epoch_context(0), 0)


def test_checkpoint_round_trip_of_the_tensor_count_and_rate(tmp_path):
    """The count and rate are written as numbers and restored into the
    state's own tensors, in place (a captured step holds their addresses)."""
    task = _toy_task("jepa")
    state = task.init_state(0)
    for _ in range(2):
        state, _ = task.train_step(state, _batch(), 1)
    payload = t_ckpt.state_payload(state, task.model.state_dict(), task.tx)
    assert payload["optimizer"]["count"] == 2 and type(payload["optimizer"]["count"]) is int
    assert payload["optimizer"]["learning_rate"] == float(state.opt_state.learning_rate)
    path = t_ckpt.save_checkpoint(tmp_path / "c.ckpt", payload, {"epoch": 1})
    fresh = _toy_task("jepa")
    new = fresh.init_state(5)
    count, lr = new.opt_state.count, new.opt_state.learning_rate
    t_ckpt.restore_state(t_ckpt.load_checkpoint(path), new, fresh.model, fresh.tx)
    assert new.opt_state.count is count and new.opt_state.learning_rate is lr
    assert int(count) == 2 and float(lr) == float(state.opt_state.learning_rate)
    assert count.dtype == torch.int32 and lr.dtype == torch.float32
    a, b = _snapshot(state), _snapshot(new)
    assert all(torch.equal(a[k], b[k]) for k in a)


def _jax_bench_keys():
    """The keys of the result dict that ``bench.py`` prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no result dict")


@pytest.mark.parametrize("task,extra", [("mae", []), ("jepa", []), ("classifier", []),
                                        ("mae", ["--fused", "--no-augment"])])
def test_bench_main_prints_the_jax_bench_keys(monkeypatch, capsys, task, extra):
    monkeypatch.setenv("SSRL_TORCH_DEVICE", "cpu")
    out = bench.main(["--task", task, "--tiny", "--batch-size", "8", "--steps", "2",
                      "--warmup", "1", *extra])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(last) == _jax_bench_keys() and last == out
    assert last["platform"] == "cpu" and last["chips"] == 1 and last["batch_size"] == 8
    assert last["dispatch"] == ("fused" if "--fused" in extra else "per-step")
    assert last["mfu"] is None and last["device_step_ms"] is None  # no card: no device numbers
    assert last["value"] > 0 and last["flops_per_image"] > 0
