"""Data parallelism of the port over ``torch.distributed``, on the CPU.

``process_local_indices`` against the JAX function; then two ``gloo`` ranks
(``tests/torch_dp_worker.py``, the port only, as processes of their own)
each take half of one global batch of B=8 through one MAE step and one
JEPA step, from the same weights, EMA target and injected draws as the
parent's single-process port step and the JAX package's single-device step
on the whole batch. A DP step over N ranks computes the single-device step
on the same global batch: the ranks' all-reduced loss sums, metric sums
(JEPA's std and cosine among them), gradients, params after the update and
EMA target are held to both, at the f32 bounds of
``tests/test_torch_lineage.py`` (loss rel 1e-5, gradients atol 1e-6 + rtol
1e-4, params within 2·lr and within 1e-3·lr where the gradient is clearly
nonzero). In the same spawn: the masks each rank draws itself are its rows
of the single process's global draw, ``_shard_for_process`` shards, and
a one-epoch ``Trainer.fit`` in which only rank 0 writes files.

Geometry: 96 px, patch 8, encoder 48/2/4, MAE decoder and JEPA predictor
32/1/4. The draws are JAX's, made as ``Task._local_train_step`` makes them
and injected (``tests/test_torch_mae_step.py``).
"""

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.data.stl10 import write_synthetic_stl10
from ssrl_vit_mae_jepa_torch.parallel import multihost as t_mh
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_tpu.ops.augment import draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.jepa_masking import sample_jepa_masks
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.parallel import multihost as j_mh
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from tests.conftest import scrubbed_cpu_env

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
B = 8  # the global batch: 4 rows a rank
EPOCH = 1
MODEL = {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
         "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
         "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4}}
MAE_CFG = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
           "total_epochs": 800, "warmup_epochs": 1, "batch_size": B,
           "base_learning_rate": 1e-2, "weight_decay": 0.05}
JEPA_CFG = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": B,
            "base_learning_rate": 1e-2, "weight_decay": 0.05,
            "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4,
            "num_target_blocks": 4, "target_scale": [0.15, 0.2],
            "target_aspect_ratio": [0.75, 1.5], "ema_start": 0.99, "ema_end": 1.0}
# the one-epoch fit: 40 unlabeled images, 32 train and 8 val, B=8 global
FIT_CFG = {**MAE_CFG, "total_epochs": 1, "val_split": 0.2, "num_workers": 0}
F32_TOL = {"atol": 1e-6, "rtol": 1e-4}


@pytest.mark.parametrize("n,count", [(12, 4), (11, 4), (7, 1)], ids=["even", "uneven", "single"])
def test_process_local_indices_matches_jax(n, count):
    idx = np.arange(100, 100 + n)
    for i in range(count):
        got = t_mh.process_local_indices(idx, i, count)
        np.testing.assert_array_equal(got, j_mh.process_local_indices(idx, i, count))


def test_without_a_group_nothing_starts(monkeypatch):
    for var in ("SSRL_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not t_mh.maybe_initialize_distributed("cpu")
    assert (t_mh.world_size(), t_mh.rank(), t_mh.is_main_process()) == (1, 0, True)
    np.testing.assert_array_equal(t_mh.process_local_indices(np.arange(5)), np.arange(5))


def test_no_card_refuses_the_default_group(monkeypatch):
    """With a process group configured, no device named and no card, the
    bootstrap raises in words and creates no group (it used to fall back to
    the CPU and ``gloo`` without a word); the caller names the CPU to get
    it."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    monkeypatch.delenv("SSRL_COORDINATOR", raising=False)
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": "1", "RANK": "0", "WORLD_SIZE": "1"}
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mh.maybe_initialize_distributed()
    assert not t_mh.is_initialized()


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(kind):
    """The JAX single-device step at the global batch and the port's
    single-process step from the same params and draws; and what the
    ranks need to take the same step."""
    images = np.random.default_rng(0).integers(0, 256, (B, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(B, np.int32),
             "weight": np.array([1, 1, 0.5, 1, 1, 0.25, 1, 1], np.float32)}
    if kind == "mae":
        jt = JMAETask(MODEL, MAE_CFG, dtype=jnp.float32)
        tt = TMAETask(MODEL, MAE_CFG, dtype=torch.float32, device="cpu")
    else:
        jt = JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32)
        tt = TJEPATask(MODEL, JEPA_CFG, dtype=torch.float32, device="cpu")
    jstate = jt.init_state(jax.random.PRNGKey(0))
    if kind == "jepa":  # an EMA target of its own, away from the encoder
        leaves, tdef = jax.tree.flatten(jstate.extra)
        keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
        jstate = jstate.replace(extra=jax.tree.unflatten(
            tdef, [a + 0.02 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)]))
    ctx = jt.epoch_context(EPOCH)
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, B)
    if kind == "mae":
        masks = random_token_mask(task_rng, B, jt.sequence_length, ctx)
    else:
        masks = sample_jepa_masks(task_rng, B, jt.grid_size, jt.num_blocks, jt.block_area,
                                  jt.context_size, jt.aspect_range,
                                  context_sampling=jt.context_sampling,
                                  context_scale=jt.context_scale)
    draws = (_t(u), _t(flip), *(_t(m).long() for m in masks))
    jimages = jt.preprocess_train(aug_rng, images)

    def loss_fn(p):
        return jt.loss_and_metric_sums_in_step(p, jstate, jimages, batch, task_rng, ctx)

    (_, jsums), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    jnew, _ = jt.train_step(jax.tree.map(jnp.array, jstate), batch, EPOCH, ctx)
    to_state = interop.mae_params_to_state if kind == "mae" else interop.jepa_params_to_state

    ts = tt.init_state(0)
    (interop.mae_params_from_jax if kind == "mae" else interop.jepa_params_from_jax)(
        _np(jstate.params), tt.model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ranks_in = {"state": {k: v.clone() for k, v in tt.model.state_dict().items()},
                "batch": tbatch, "draws": draws}
    if kind == "jepa":
        ts.extra = {k: torch.from_numpy(v)
                    for k, v in interop.vit_params_to_state(_np(jstate.extra)).items()}
        ranks_in["extra"] = {k: v.clone() for k, v in ts.extra.items()}
    names, grads, sums = tt.gradients(ts, tbatch, ctx, draws)
    ts, step_sums = tt.train_step(ts, tbatch, EPOCH, ctx, draws)
    single = {"grads": dict(zip(names, grads)), "sums": sums, "lr": step_sums["lr"],
              "params": {k: v.detach() for k, v in ts.params.items()},
              "extra": ts.extra,
              "draws": tt.draw(torch.Generator().manual_seed(11), B, ctx)}
    jax_ref = {"grads": to_state(_np(jgrads)), "sums": _np(jsums),
               "params": to_state(_np(jnew.params)),
               "extra": None if kind == "mae" else interop.vit_params_to_state(_np(jnew.extra))}
    return ranks_in, single, jax_ref


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Two gloo ranks on the CPU; their results beside the references."""
    tmp = tmp_path_factory.mktemp("dp")
    mae_in, mae_single, mae_jax = _case("mae")
    jepa_in, jepa_single, jepa_jax = _case("jepa")
    write_synthetic_stl10(tmp / "data", num_train=10, num_test=10, num_unlabeled=40, seed=0)
    torch.save({"model": MODEL, "mae_cfg": MAE_CFG, "jepa_cfg": JEPA_CFG, "fit_cfg": FIT_CFG,
                "epoch": EPOCH, "mae": mae_in, "jepa": jepa_in,
                "data_dir": str(tmp / "data")}, tmp / "inputs.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dp_worker.py"), str(tmp / "inputs.pt"),
         str(tmp)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=scrubbed_cpu_env(RANK=str(r), WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                             OMP_NUM_THREADS="2"))
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{out[-2000:]}\n{err[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"tmp": tmp, "ranks": ranks,
            "mae": (mae_single, mae_jax), "jepa": (jepa_single, jepa_jax)}


def _check_step(got, want, lr):
    """A rank's step against a reference step on the whole batch."""
    for k in ("loss_sum", "weight_sum"):
        assert float(got["sums"][k]) == pytest.approx(float(want["sums"][k]), rel=1e-5), k
    assert set(got["grads"]) == set(want["grads"]) - {"encoder.mask_token"}
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want["grads"][k]), **F32_TOL,
                                   err_msg=k)
    for k, p in got["params"].items():
        p, w, g = p.numpy(), np.asarray(want["params"][k]), np.asarray(want["grads"][k])
        np.testing.assert_allclose(p, w, atol=2 * lr, rtol=0, err_msg=k)
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p[sure], w[sure], atol=1e-3 * lr, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["mae", "jepa"])
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_dp_step_is_the_single_device_step(dp, kind, ref):
    """Both ranks' reduced sums, gradients and updated params equal the
    single-device step on the global batch (the port's single process or
    the JAX package), and the two ranks hold the same bits."""
    single, jax_ref = dp[kind]
    want = single if ref == "port" else jax_ref
    r0, r1 = (r[kind] for r in dp["ranks"])
    assert r0["lr"] == r1["lr"] == pytest.approx(single["lr"], rel=1e-12)
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for rk in (r0, r1):
        _check_step(rk, want, single["lr"])
        for k in rk["sums"]:
            assert torch.equal(rk["sums"][k], r0["sums"][k]), k
            assert torch.equal(rk["step_sums"][k], r0["sums"][k]), k


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_dp_jepa_metrics_and_ema(dp, ref):
    """The collapse metrics (std from the moments summed over the ranks, the
    cosine, the EMA drift) and the EMA target after the step; the EMA is
    the same bits on both ranks (rank 0's, broadcast, equals each rank's)."""
    single, jax_ref = dp["jepa"]
    want = single if ref == "port" else jax_ref
    lr = single["lr"]
    m = 0.99 + 0.01 * EPOCH / JEPA_CFG["total_epochs"]
    for rk in (r["jepa"] for r in dp["ranks"]):
        for k in ("pred_std_sum", "target_std_sum", "cos_sum", "ema_drift_sum"):
            assert float(rk["sums"][k]) == pytest.approx(float(want["sums"][k]), rel=1e-5), k
        assert rk["extra_equals_rank0"]
        for k, v in rk["extra"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want["extra"][k]),
                                       atol=2 * lr * (1 - m) + 1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["mae", "jepa"])
def test_dp_ranks_draw_their_rows_of_the_global_draw(dp, kind):
    single = dp[kind][0]
    for r, rk in enumerate(dp["ranks"]):
        assert rk["axis"] == (WORLD, r)
        b = B // WORLD
        for mine, full in zip(rk[kind]["own_draws"], single["draws"]):
            assert torch.equal(mine, full[r * b:(r + 1) * b])


def test_dp_index_shards(dp):
    """Even: disjoint and covering. Uneven: wrap-around padded to equal
    size, covering. Both at half the global batch; an indivisible global
    batch is refused."""
    s = [r["shards"] for r in dp["ranks"]]
    (a, ba), (b, bb) = s[0]["even"], s[1]["even"]
    assert ba == bb == 4 and not set(a) & set(b) and set(a) | set(b) == set(range(12))
    (a, _), (b, _) = s[0]["uneven"], s[1]["uneven"]
    assert len(a) == len(b) == 6 and set(a) | set(b) == set(range(11))
    np.testing.assert_array_equal(np.concatenate([a, b]), np.resize(np.arange(11), 12))
    assert all("not divisible" in x["indivisible"] for x in s)


def test_dp_fit_rank0_writes(dp):
    """One epoch of ``Trainer.fit`` on both ranks: each loader holds half
    of the split at half the global batch, the metrics agree across ranks,
    ``images_per_s`` counts both ranks, and only rank 0 wrote files."""
    f0, f1 = (r["fit"] for r in dp["ranks"])
    assert f0["batch_size"] == f1["batch_size"] == B // WORLD
    assert f0["steps"] == f1["steps"] == 4 and f0["num_examples"] == f1["num_examples"] == 16
    assert not set(f0["train_indices"]) & set(f1["train_indices"])
    for k in ("train_loss", "val_loss"):
        assert f0["metrics"][k] == f1["metrics"][k]
    m = f0["metrics"]
    assert m["images_per_s"] * m["epoch_time_s"] == pytest.approx(2 * f0["num_examples"])
    run0, run1 = dp["tmp"] / "run0", dp["tmp"] / "run1"
    for f in ("metrics.jsonl", "checkpoints/best.ckpt", "checkpoints/last.ckpt"):
        assert (run0 / f).is_file(), f
    assert not run1.exists()
    assert f1["best_path"] == run1 / "checkpoints" / "best.ckpt"
