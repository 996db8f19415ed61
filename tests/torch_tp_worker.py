"""One rank of the tensor-parallel checks of ``tests/test_torch_tp.py``.

Run as ``python tests/torch_tp_worker.py INPUTS OUT_DIR MP`` with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, one process per
rank, on the CPU (``gloo``). It imports the port only. It joins the
(WORLD_SIZE // MP, MP) grid of ``parallel/mesh.py::get_mesh``; from
``INPUTS`` (written by the test) it takes the configurations and, for each
case (MAE, JEPA with its EMA target, the classifier fully trained and with
a frozen encoder), the full weights, the global batch and the global draws
of one step. It runs its data rank's rows of each step on its shards and
reports the gathered gradients, params and EMA target and its own copies of
the replicated params. In the (1, MP) grid it also checks ``shard_params``
/ ``gather_params`` and the sharded clip norm, and fits a toy MAE over an
active mask ramp: one epoch then a resume to two, beside two epochs
straight, with the gathered state at the first checkpoint. It saves what it
saw to ``OUT_DIR/rank<r>.pt``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from ssrl_vit_mae_jepa_torch.data.loaders import get_pretrain_dataloaders
from ssrl_vit_mae_jepa_torch.parallel.mesh import gather_params, get_mesh, shard_params, shard_spec
from ssrl_vit_mae_jepa_torch.parallel.multihost import maybe_initialize_distributed
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
from ssrl_vit_mae_jepa_torch.training.optim import global_sq_sum
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask
from ssrl_vit_mae_jepa_torch.training.trainer import Trainer


def make_task(kind: str, inputs: dict):
    f32 = dict(dtype=torch.float32, device="cpu")
    if kind == "mae":
        return MAETask(inputs["model"], inputs["mae_cfg"], **f32)
    if kind == "jepa":
        return JEPATask(inputs["model"], inputs["jepa_cfg"], **f32)
    task = ClassifierTask(inputs["model"], inputs["cls_cfg"], **f32)
    task.set_freeze_policy(freeze_encoder=kind == "cls_probe")
    return task


def _full(t: dict, tp) -> dict:
    return {k: v.detach().clone() for k, v in gather_params(t, tp).items()}


def step(kind: str, inputs: dict, grid) -> dict:
    """This rank's rows of one global step on its shards."""
    case = inputs[kind]
    tp, data = grid.model, grid.data
    task = make_task(kind, inputs)
    task.configure_sharding(grid)
    state = task.init_state(0, init_params_override=lambda _: case["state"])
    if "extra" in case:
        state.extra = shard_params(case["extra"], tp)
    b = case["batch"]["image"].shape[0] // data.size
    lo = data.rank * b
    batch = {k: v[lo:lo + b] for k, v in case["batch"].items()}
    draws = tuple(None if d is None else d[lo:lo + b] for d in case["draws"])
    ctx = task.epoch_context(inputs["epoch"])
    names, grads, sums = task.gradients(state, batch, ctx, draws)
    state, step_sums = task.train_step(state, batch, inputs["epoch"], ctx, draws)
    out = {"grads": _full(dict(zip(names, grads)), tp), "sums": sums,
           "lr": step_sums["lr"], "params": _full(state.params, tp),
           "replicated": {k: v.detach().clone() for k, v in state.params.items()
                          if shard_spec(k) is None},
           "shapes": {k: tuple(v.shape) for k, v in state.params.items()}}
    if state.extra is not None:
        out["extra"] = _full(state.extra, tp)
    return out


def units(inputs: dict, grid) -> dict:
    """shard_params then gather_params, and the sharded clip norm."""
    tp = grid.model
    full = inputs["mae"]["state"]
    back = gather_params(shard_params(full, tp), tp)
    names = list(full)
    mine = shard_params(full, tp)
    return {"identity": all(torch.equal(back[k], full[k]) for k in names),
            "sq_sum": float(global_sq_sum(names, [mine[k] for k in names], tp)),
            "sq_sum_full": float(sum(v.double().square().sum() for v in full.values()))}


def fit(inputs: dict, out_dir: Path, grid) -> dict:
    """One epoch, a resume to two, and two epochs straight, on the grid."""
    cfg = {"seed": 73, "pretrain": inputs["fit_cfg"]}
    train, val = get_pretrain_dataloaders(cfg, inputs["data_dir"])

    def trainer(epochs, name):
        task = MAETask(inputs["model"], inputs["fit_cfg"], dtype=torch.float32, device="cpu")
        return Trainer(task, epochs, out_dir / name, mesh=grid)

    a = trainer(1, "run_a")
    a.fit(train, val)
    names = a.task.tx.trainable(a.state.params)
    opt = a.state.opt_state
    first = {"params": _full(a.state.params, grid.model),
             "mu": _full(dict(zip(names, opt.mu)), grid.model),
             "nu": _full(dict(zip(names, opt.nu)), grid.model)}
    b = trainer(2, "run_b")
    b.fit(train, val, resume_from=out_dir / "run_a" / "checkpoints" / "last.ckpt")
    c = trainer(2, "run_c")
    metrics = c.fit(train, val)
    return {"first": first, "ckpt": out_dir / "run_a" / "checkpoints" / "last.ckpt",
            "resumed": _full(b.state.params, grid.model),
            "straight": _full(c.state.params, grid.model), "metrics": metrics,
            "batch_size": train.batch_size, "train_indices": train.indices}


def main() -> None:
    inputs_path, out_dir, mp = Path(sys.argv[1]), Path(sys.argv[2]), int(sys.argv[3])
    if not maybe_initialize_distributed("cpu"):
        raise SystemExit("no process group in the environment")
    grid = get_mesh(model_parallel=mp)
    inputs = torch.load(inputs_path, weights_only=False)
    rank = torch.distributed.get_rank()
    result = {"grid": (grid.data.size, grid.data.rank, grid.model.size, grid.model.rank)}
    for kind in ("mae", "jepa", "cls_full", "cls_probe"):
        result[kind] = step(kind, inputs, grid)
    if grid.data.size == 1:
        result["units"] = units(inputs, grid)
        result["fit"] = fit(inputs, out_dir, grid)
    torch.save(result, out_dir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
