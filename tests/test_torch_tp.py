"""Tensor parallelism of the port (the JAX mesh's ``model`` axis), on the CPU.

Two groups of ``gloo`` ranks, spawned once for the file as processes of
their own (``tests/torch_tp_worker.py``, the port only): two ranks in a
(1, 2) grid and four in a (2, 2) grid of ``parallel/mesh.py::get_mesh``.
From the same weights, EMA target, global batch and injected draws (the
JAX package's), each takes one step of MAE, JEPA and the classifier (fully
trained, and on a frozen encoder) on its shards, and the results of both grids
are held to the JAX step on ``get_mesh(num_devices=4, model_parallel=2)``
of ``tests/conftest.py``'s virtual devices, its state and batch placed as
the JAX ``Trainer(mesh=)`` places them (f32,
``attn_impl`` auto: the flax path off the TPU) and to the port's
single-process step. The JAX step on ``get_mesh(2, 2)`` does not compile
with this installation's XLA (a RET_CHECK of its SPMD partitioner: a psum
over the manual data axis of size 1 beside the automatic model axis), so
the (1, 2) grid is held to the (4, 2) mesh's step, the same function.

Tolerances: the gathered gradients within atol 1e-6 + rtol 1e-4 of the
single process's (``tests/test_torch_parallel.py``'s f32 bound); the
params after the step within atol 1e-5 (``tests/test_training.py``'s
DP-equals-single bound) where the gradient is clearly nonzero (above 1e-3
of its tensor's largest), and within 2·lr elsewhere: Adam's first step is
±lr per element however small the gradient, so a gradient at rounding
level (the key bias's, zero in exact arithmetic) may take either sign in
two summation orders. Replicated params keep the same bits on every rank.

Also, without a process group: the head-slice rows of ``qkv.weight``, the
shards' partial sums of a branch adding up to the whole branch (forward
and backward, the softmax scale from the shard's head dim), the refused
routes and indivisible grids; in the (1, 2) group: ``shard_params`` then
``gather_params`` is the identity, the sharded clip norm is the full one,
a checkpoint written under the grid equals the gathered state and loads in
one process, and a resume under the grid continues the same run bit for
bit. Geometry: 96 px, patch 8, encoder 48/2/4, MAE decoder and JEPA
predictor 32/1/4, B=8.
"""

import socket
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from ssrl_vit_mae_jepa_torch.data.stl10 import write_synthetic_stl10
from ssrl_vit_mae_jepa_torch.models.vit import Block
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.parallel.mesh import (
    Grid,
    ModelAxis,
    ShardSpec,
    get_mesh as t_get_mesh,
    shard_index,
)
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask as TClassifierTask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_torch.utils.checkpoint import load_checkpoint, model_state, restore_state
from ssrl_vit_mae_jepa_tpu.ops.augment import draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.jepa_masking import sample_jepa_masks
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.parallel.mesh import get_mesh as j_get_mesh
from ssrl_vit_mae_jepa_tpu.parallel.mesh import param_shardings
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.tasks import ClassifierTask as JClassifierTask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from ssrl_vit_mae_jepa_tpu.utils import torch_interop as ti
from tests.conftest import scrubbed_cpu_env

REPO = Path(__file__).resolve().parents[1]
MP = 2
GRIDS = {"1x2": 2, "2x2": 4}  # grid -> world size
B = 8
EPOCH = 1
KINDS = ("mae", "jepa", "cls_full", "cls_probe")
MODEL = {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
         "encoder": {"embed_dim": 48, "depth": 2, "num_heads": 4},
         "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
         "head": {"pool": "cls"}}
MAE_CFG = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
           "total_epochs": 800, "warmup_epochs": 1, "batch_size": B,
           "base_learning_rate": 1e-2, "weight_decay": 0.05}
JEPA_CFG = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": B,
            "base_learning_rate": 1e-2, "weight_decay": 0.05,
            "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4,
            "num_target_blocks": 4, "target_scale": [0.15, 0.2],
            "target_aspect_ratio": [0.75, 1.5], "ema_start": 0.99, "ema_end": 1.0}
CLS_CFG = {"learning_rate": 1e-2, "weight_decay": 0.05, "warmup_epochs": 1,
           "total_epochs": 10, "batch_size": B}
# the fits: 40 unlabeled images, 32 train and 8 val, B=8, the mask ratio
# ramping over the two epochs
FIT_CFG = {**MAE_CFG, "mask_ratio_start": 0.5, "mask_ramp_epochs": 2, "total_epochs": 2,
           "val_split": 0.2, "num_workers": 0}
GRAD_TOL = {"atol": 1e-6, "rtol": 1e-4}
PARAM_ATOL = 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tasks(kind):
    if kind == "mae":
        return (JMAETask(MODEL, MAE_CFG, dtype=jnp.float32),
                TMAETask(MODEL, MAE_CFG, dtype=torch.float32, device="cpu"))
    if kind == "jepa":
        return (JJEPATask(MODEL, JEPA_CFG, dtype=jnp.float32),
                TJEPATask(MODEL, JEPA_CFG, dtype=torch.float32, device="cpu"))
    jt = JClassifierTask(MODEL, CLS_CFG, dtype=jnp.float32)
    tt = TClassifierTask(MODEL, CLS_CFG, dtype=torch.float32, device="cpu")
    for t in (jt, tt):
        t.set_freeze_policy(freeze_encoder=kind == "cls_probe")
    return jt, tt


def _to_state(kind):
    return {"mae": interop.mae_params_to_state, "jepa": interop.jepa_params_to_state}.get(
        kind, interop.classifier_params_to_state)


def _flax_params(kind, state):
    """The port's init as the JAX task's params, through the JAX package's
    importers (no flax init to compile)."""
    st = {k: v.detach().numpy() for k, v in state.items()}
    depth = MODEL["encoder"]["depth"]
    if kind == "mae":
        return ti.mae_state_to_params(st, depth, MODEL["decoder"]["decoder_depth"])[0]
    if kind == "jepa":
        sub = lambda pre: {k[len(pre):]: v for k, v in st.items() if k.startswith(pre)}  # noqa
        return {"encoder": ti.timm_vit_to_params(sub("encoder."), depth)[0],
                "predictor": ti.lightly_decoder_to_params(
                    sub("predictor."), JEPA_CFG["predictor_depth"])[0],
                "predictor_proj": {"kernel": st["predictor_proj.weight"].T,
                                   "bias": st["predictor_proj.bias"]}}
    return ti.classifier_state_to_params(st, depth)[0]


def _inputs(kind):
    """One step's weights (the port's seeded init, given to the JAX task),
    batch and JAX-drawn augmentation and masks; JEPA's EMA target moved
    away from the encoder."""
    images = np.random.default_rng(0).integers(0, 256, (B, 96, 96, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.arange(B, dtype=np.int32) % 10,
             "weight": np.array([1, 1, 0.5, 1, 1, 0.25, 1, 1], np.float32)}
    jt, tt = _tasks(kind)
    tt.init_state(0)
    state = {k: v.detach().clone() for k, v in tt.model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, _flax_params(kind, state))
    jt.init_params = lambda rng: params
    jstate = jt.init_state(jax.random.PRNGKey(0))
    if kind == "jepa":
        leaves, tdef = jax.tree.flatten(jstate.extra)
        noise = np.random.default_rng(7)
        jstate = jstate.replace(extra=jax.tree.unflatten(tdef, [
            a + jnp.asarray(0.02 * noise.standard_normal(a.shape), jnp.float32)
            for a in leaves]))
    ctx = jt.epoch_context(EPOCH)
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, B)
    masks = ()
    if kind == "mae":
        masks = random_token_mask(task_rng, B, jt.sequence_length, ctx)
    elif kind == "jepa":  # jitted: eager, its many small ops each compile
        masks = jax.jit(partial(
            sample_jepa_masks, batch_size=B, grid_size=jt.grid_size, num_blocks=jt.num_blocks,
            block_area=jt.block_area, context_size=jt.context_size,
            aspect_range=jt.aspect_range, context_sampling=jt.context_sampling,
            context_scale=jt.context_scale))(task_rng)
    ranks_in = {"state": state, "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                "draws": (_t(u), _t(flip), *(_t(m).long() for m in masks))}
    if kind == "jepa":
        ranks_in["extra"] = {k: torch.from_numpy(v) for k, v in
                             interop.vit_params_to_state(_np(jstate.extra)).items()}
    return (jt, tt, jstate, batch, ctx), ranks_in


def _references(kind, made, ranks_in):
    """The JAX step on ``get_mesh(4, 2)`` and the port's single-process
    step, from the same params and draws."""
    jt, tt, jstate, batch, ctx = made
    mesh = j_get_mesh(num_devices=4, model_parallel=MP)
    assert mesh.shape == {"data": 2, "model": MP}
    # what ``Trainer(mesh=)`` does (trainer.py:60-95 there: configure_sharding,
    # _place_state, _batch_shardings), without its metrics logger's import
    jt.configure_sharding(mesh)
    placed = jax.device_put(jax.tree.map(jnp.array, jstate), param_shardings(jstate, mesh))
    jnew, jsums = jt.train_step(
        placed, jax.device_put(batch, NamedSharding(mesh, PartitionSpec("data"))), EPOCH, ctx)
    jax_ref = {"params": _to_state(kind)(_np(jnew.params)), "sums": _np(jsums),
               "extra": None if jnew.extra is None
               else interop.vit_params_to_state(_np(jnew.extra))}
    ts = tt.init_state(0)
    if "extra" in ranks_in:
        ts.extra = {k: v.clone() for k, v in ranks_in["extra"].items()}
    tbatch, draws = ranks_in["batch"], ranks_in["draws"]
    names, grads, sums = tt.gradients(ts, tbatch, ctx, draws)
    ts, step_sums = tt.train_step(ts, tbatch, EPOCH, ctx, draws)
    single = {"grads": dict(zip(names, grads)), "sums": sums, "lr": step_sums["lr"],
              "params": {k: v.detach() for k, v in ts.params.items()}, "extra": ts.extra}
    return single, jax_ref


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, inputs: Path, out: Path):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_tp_worker.py"), str(inputs), str(out),
         str(MP)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=scrubbed_cpu_env(RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                             OMP_NUM_THREADS="1"))
        for r in range(world)]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Both gloo groups on the CPU, run side by side; their results beside
    the references."""
    tmp = tmp_path_factory.mktemp("tp")
    write_synthetic_stl10(tmp / "data", num_train=10, num_test=10, num_unlabeled=40, seed=0)
    made = {kind: _inputs(kind) for kind in KINDS}
    inputs = {"model": MODEL, "mae_cfg": MAE_CFG, "jepa_cfg": JEPA_CFG, "cls_cfg": CLS_CFG,
              "fit_cfg": FIT_CFG, "epoch": EPOCH, "data_dir": str(tmp / "data"),
              **{kind: m[1] for kind, m in made.items()}}
    torch.save(inputs, tmp / "inputs.pt")
    procs = {}
    for name, world in GRIDS.items():
        (tmp / name).mkdir()
        procs[name] = _spawn(world, tmp / "inputs.pt", tmp / name)
    outs = {}
    try:
        # the references while the ranks run
        cases = {kind: (m[1], *_references(kind, *m)) for kind, m in made.items()}
        for name, ps in procs.items():
            outs[name] = [p.communicate(timeout=300) for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    ranks = {}
    for name, ps in procs.items():
        for p, (out, err) in zip(ps, outs[name]):
            assert p.returncode == 0, f"{name}: {out[-2000:]}\n{err[-4000:]}"
        ranks[name] = [torch.load(tmp / name / f"rank{r}.pt", weights_only=False)
                       for r in range(GRIDS[name])]
    return {"tmp": tmp, "ranks": ranks, "cases": cases}


def _check_params(got, want, grads, lr):
    """Trained params within 2·lr, and PARAM_ATOL where the gradient is
    clearly nonzero; frozen ones (no gradient) the same bits."""
    for k, p in got.items():
        p, w = p.numpy(), np.asarray(want[k])
        if k not in grads:
            np.testing.assert_array_equal(p, w, err_msg=k)
            continue
        g = np.asarray(grads[k])
        np.testing.assert_allclose(p, w, atol=2 * lr, rtol=0, err_msg=k)
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p[sure], w[sure], atol=PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_step_equals_jax_mesh_and_single_process(tp, grid, kind):
    """Every rank's gathered step equals the JAX step on the (2, 2) mesh and
    the port's single process: the loss and metric sums, the gradients,
    the params after the update and (JEPA) the EMA target; the ranks hold
    their own shards, and the replicated params are the same bits on every
    rank."""
    _, single, want = tp["cases"][kind]
    ranks = [r[kind] for r in tp["ranks"][grid]]
    lr = single["lr"]
    for rk in ranks:
        assert rk["lr"] == pytest.approx(lr, rel=1e-12)
        for k in ("loss_sum", "weight_sum"):
            assert float(rk["sums"][k]) == pytest.approx(float(single["sums"][k]), rel=1e-5), k
            assert float(rk["sums"][k]) == pytest.approx(float(want["sums"][k]), rel=1e-5), k
        assert set(rk["grads"]) == set(single["grads"])
        for k, g in rk["grads"].items():
            np.testing.assert_allclose(g.numpy(), single["grads"][k].numpy(), **GRAD_TOL,
                                       err_msg=k)
        _check_params(rk["params"], {k: v.numpy() for k, v in single["params"].items()},
                      single["grads"], lr)
        _check_params({k: v for k, v in rk["params"].items() if k in want["params"]},
                      want["params"], single["grads"], lr)
        for k in single["params"]:
            if k.endswith("attn.qkv.weight"):
                D = single["params"][k].shape[1]
                assert rk["shapes"][k] == (3 * D // MP, D), k
        if kind == "jepa":
            m = 0.99 + 0.01 * EPOCH / JEPA_CFG["total_epochs"]
            for k, v in rk["extra"].items():
                for ref in (single["extra"][k].numpy(), want["extra"][k]):
                    np.testing.assert_allclose(v.numpy(), ref, atol=2 * lr * (1 - m) + 1e-6,
                                               rtol=0, err_msg=k)
            for k in ("pred_std_sum", "target_std_sum", "cos_sum", "ema_drift_sum"):
                assert float(rk["sums"][k]) == pytest.approx(float(single["sums"][k]),
                                                             rel=1e-5), k
    for k, v in ranks[0]["replicated"].items():
        for rk in ranks[1:]:
            assert torch.equal(rk["replicated"][k], v), k


def test_tp_grid_layout(tp):
    """Rank d·mp + m is data rank d and model rank m (the JAX mesh's
    ``reshape(n // mp, mp)``)."""
    for name, world in GRIDS.items():
        for r, rk in enumerate(tp["ranks"][name]):
            assert rk["grid"] == (world // MP, r // MP, MP, r % MP)


def test_tp_shard_gather_and_clip_norm(tp):
    """``shard_params`` then ``gather_params`` is the identity, and the
    sharded sum of squares (the clip's norm) is the full one."""
    for rk in tp["ranks"]["1x2"]:
        u = rk["units"]
        assert u["identity"]
        assert u["sq_sum"] == pytest.approx(u["sq_sum_full"], rel=1e-6)


def test_tp_checkpoint_is_full_and_loads_in_one_process(tp):
    """The checkpoint written under the (1, 2) grid holds the gathered
    params and Adam moments, full size, and a single process resumes
    from it into the same tensors."""
    fit0 = tp["ranks"]["1x2"][0]["fit"]
    first, path = fit0["first"], fit0["ckpt"]
    ckpt = load_checkpoint(path)
    state = model_state(ckpt)
    for k, v in first["params"].items():
        assert torch.equal(state[k], v), k
    for key in ("mu", "nu"):
        assert set(ckpt["optimizer"][key]) == set(first[key])
        for k, v in first[key].items():
            assert torch.equal(ckpt["optimizer"][key][k], v), (key, k)
    task = TMAETask(MODEL, FIT_CFG, dtype=torch.float32, device="cpu")
    state = restore_state(ckpt, task.init_state(0), task.model, task.tx)
    for k, v in first["params"].items():
        assert torch.equal(state.params[k].detach(), v), k
    names = task.tx.trainable(state.params)
    for k, m, n in zip(names, state.opt_state.mu, state.opt_state.nu):
        assert torch.equal(m, first["mu"][k]) and torch.equal(n, first["nu"][k]), k
    assert ckpt["epoch"] == 0


def test_tp_resume_continues_the_run(tp):
    """One epoch, then a resume under the grid to the second, gives the two
    epochs' params bit for bit; the loaders of both model ranks hold the
    same rows at the whole batch."""
    f0, f1 = (r["fit"] for r in tp["ranks"]["1x2"])
    for f in (f0, f1):
        for k, v in f["straight"].items():
            assert torch.equal(f["resumed"][k], v), k
        assert f["batch_size"] == B
    np.testing.assert_array_equal(f0["train_indices"], f1["train_indices"])
    assert f0["metrics"]["train_loss"] == f1["metrics"]["train_loss"]


# ---------------------------------------------------------------------------
# Without a process group
# ---------------------------------------------------------------------------


def test_qkv_head_slice_rows():
    """Model rank m holds the q, k and v rows of heads [m·H/mp, (m+1)·H/mp)
    of ``qkv.weight`` and their bias, the same heads' columns of proj, and
    the m-th F/mp slice of fc1 (rows) and fc2 (columns)."""
    D, H, F_, mp, d = 48, 4, 192, 2, 12
    for m in range(mp):
        blk = Block(D, H, dtype=torch.float32)
        full = {k: v.clone() for k, v in blk.state_dict().items()}
        blk.shard_(ModelAxis(mp, m))
        heads = range(m * H // mp, (m + 1) * H // mp)
        rows = [c * D + h * d + i for c in range(3) for h in heads for i in range(d)]
        assert torch.equal(blk.attn.qkv.weight, full["attn.qkv.weight"][rows])
        assert torch.equal(blk.attn.qkv.bias, full["attn.qkv.bias"][rows])
        cols = rows[:len(rows) // 3]
        assert torch.equal(blk.attn.proj.weight, full["attn.proj.weight"][:, cols])
        assert torch.equal(blk.attn.proj.bias, full["attn.proj.bias"])
        fs = slice(m * F_ // mp, (m + 1) * F_ // mp)
        assert torch.equal(blk.mlp.fc1.weight, full["mlp.fc1.weight"][fs])
        assert torch.equal(blk.mlp.fc1.bias, full["mlp.fc1.bias"][fs])
        assert torch.equal(blk.mlp.fc2.weight, full["mlp.fc2.weight"][:, fs])
        assert torch.equal(blk.norm1.weight, full["norm1.weight"])
        assert shard_index(ShardSpec(0, 3), 3 * D, mp, m).tolist() == rows


@pytest.mark.parametrize("mp", [2, 3])
def test_shard_partials_sum_to_the_branch(mp):
    """The partial forwards of the mp shards, summed, then finished, equal
    the whole branch; their partial backwards, summed, then the LN
    backward, equal the whole branch's backward, and the shards' weight
    gradients are the slices of the whole ones. The softmax scale comes
    from the shard's own head dim (Da / (H/mp) = D / H)."""
    g = torch.Generator().manual_seed(0)
    B, L, D, H = 2, 9, 48, 6
    F_ = 4 * D
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = r(B, L, D)
    p_attn = (1 + 0.1 * r(D), 0.1 * r(D), 0.2 * r(3 * D, D), 0.1 * r(3 * D), 0.2 * r(D, D),
              0.1 * r(D))
    p_mlp = (1 + 0.1 * r(D), 0.1 * r(D), 0.2 * r(F_, D), 0.1 * r(F_), 0.2 * r(D, F_),
             0.1 * r(D))
    gy = r(B, L, D)
    want_a, a_full = bf.attn_fwd_plain(x, p_attn, H)
    want_m = bf.mlp_fwd_plain(x, p_mlp)
    dx_a, grads_a = bf.attn_bwd_plain(x, p_attn, a_full, gy, H)
    dx_m, grads_m = bf.mlp_bwd_plain(x, p_mlp, gy, round_z=True)
    s_a = s_m = dy_a = dy_m = 0
    for m in range(mp):
        rows = shard_index(ShardSpec(0, 3), 3 * D, mp, m)
        cols = shard_index(ShardSpec(1), D, mp, m)
        fs = shard_index(ShardSpec(0), F_, mp, m)
        pa = (p_attn[0], p_attn[1], p_attn[2][rows], p_attn[3][rows], p_attn[4][:, cols])
        pm = (p_mlp[0], p_mlp[1], p_mlp[2][fs], p_mlp[3][fs], p_mlp[4][:, fs])
        assert bf.tp_scale(pa[2], H // mp) == bf._scale(D, H)
        part, a = bf.attn_part_plain(x, pa, H // mp)
        torch.testing.assert_close(a, a_full[..., cols], rtol=0, atol=1e-6)
        s_a = s_a + part
        s_m = s_m + bf.mlp_part_plain(x, pm)
        dy, (dwqkv, dbqkv, dwp) = bf.attn_part_bwd_plain(x, pa, a, gy, H // mp)
        dy_a = dy_a + dy
        for got, full in ((dwqkv, grads_a[2][rows]), (dbqkv, grads_a[3][rows]),
                          (dwp, grads_a[4][:, cols])):
            torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)
        dy, (dw1, db1, dw2) = bf.mlp_part_bwd_plain(x, pm, gy)
        dy_m = dy_m + dy
        for got, full in ((dw1, grads_m[2][fs]), (db1, grads_m[3][fs]), (dw2, grads_m[4][:, fs])):
            torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bf.branch_finish_plain(x, s_a, p_attn[5]), want_a,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bf.branch_finish_plain(x, s_m, p_mlp[5]), want_m,
                               rtol=1e-5, atol=1e-5)
    for dy, dx_want, grads, ln_s in ((dy_a, dx_a, grads_a, p_attn[0]),
                                     (dy_m, dx_m, grads_m, p_mlp[0])):
        dx, (ds, db, dbias) = bf.ln_bwd_plain(x, ln_s, dy, gy)
        torch.testing.assert_close(dx, dx_want, rtol=1e-4, atol=1e-5)
        for got, want in ((ds, grads[0]), (db, grads[1]), (dbias, grads[5])):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["block", "chain", "packed", "pallas", "stacked"])
def test_refused_routes_under_model_parallel(impl):
    """The whole-block, chain and attention-kernel routes refuse a model
    axis, naming the route, as the JAX package refuses them."""
    task = TMAETask(MODEL, MAE_CFG, dtype=torch.float32, device="cpu", attn_impl=impl)
    with pytest.raises(ValueError, match=f"attn_impl='{impl}'.*model_parallel > 1"):
        task.configure_sharding(Grid(None, ModelAxis(2, 0)))


def test_grid_refuses_indivisible_axes():
    """``get_mesh`` refuses a world that ``model_parallel`` does not divide
    (here one process), and a grid whose model axis does not divide a
    stack's heads (the JEPA predictor's too) is refused when the task is
    given it."""
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        t_get_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="num_devices=4"):
        t_get_mesh(num_devices=4)
    task = TMAETask(MODEL, MAE_CFG, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="4 heads .* model_parallel=3"):
        task.configure_sharding(Grid(None, ModelAxis(3, 0)))
    jepa = {**JEPA_CFG, "predictor_num_heads": 2, "predictor_embed_dim": 32}
    task = TJEPATask({**MODEL, "encoder": {**MODEL["encoder"], "num_heads": 4}}, jepa,
                     dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="2 heads .* model_parallel=4"):
        task.configure_sharding(Grid(None, ModelAxis(4, 0)))
