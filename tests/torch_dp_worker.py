"""One rank of the data-parallel checks of ``tests/test_torch_parallel.py``.

Run as ``python tests/torch_dp_worker.py INPUTS OUT_DIR`` with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, one process per
rank, on the CPU (``gloo``). It imports the port only. From ``INPUTS``
(written by the test) it takes the configurations, the MAE and JEPA weights
(and EMA target), the global batch and the global draws of one step; it
joins the group through ``maybe_initialize_distributed``, runs its rows of
each step over the data axis, shards indices, and fits a toy MAE for one
epoch on the synthetic STL-10 the test wrote; then it saves what it saw to
``OUT_DIR/rank<r>.pt``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.data.loaders import _shard_for_process, get_pretrain_dataloaders
from ssrl_vit_mae_jepa_torch.parallel.mesh import broadcast_from, get_data_axis
from ssrl_vit_mae_jepa_torch.parallel.multihost import maybe_initialize_distributed
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask
from ssrl_vit_mae_jepa_torch.training.trainer import Trainer


def make_task(kind: str, inputs: dict):
    if kind == "mae":
        return MAETask(inputs["model"], inputs["mae_cfg"], dtype=torch.float32, device="cpu")
    return JEPATask(inputs["model"], inputs["jepa_cfg"], dtype=torch.float32, device="cpu")


def step(kind: str, inputs: dict, axis) -> dict:
    """This rank's rows of the global step: reduced gradients and sums, then
    the update; and the EMA target broadcast from rank 0 against its own."""
    case = inputs[kind]
    task = make_task(kind, inputs)
    state = task.init_state(0)
    task.model.load_state_dict(case["state"], strict=True)
    if "extra" in case:
        state.extra = {k: v.clone() for k, v in case["extra"].items()}
    task.configure_sharding(axis)
    b = case["batch"]["image"].shape[0] // axis.size
    lo = axis.rank * b
    batch = {k: v[lo:lo + b] for k, v in case["batch"].items()}
    draws = tuple(None if d is None else d[lo:lo + b] for d in case["draws"])
    ctx = task.epoch_context(inputs["epoch"])
    names, grads, sums = task.gradients(state, batch, ctx, draws)
    state, step_sums = task.train_step(state, batch, inputs["epoch"], ctx, draws)
    out = {"grads": dict(zip(names, grads)), "sums": sums,
           "step_sums": {k: v for k, v in step_sums.items() if k != "lr"},
           "lr": step_sums["lr"],
           "params": {k: v.detach().clone() for k, v in state.params.items()},
           # the masks this rank draws itself, at the global size, sliced
           "own_draws": task.draw(torch.Generator().manual_seed(11), b, ctx)}
    if state.extra is not None:
        keys = sorted(state.extra)
        mine = [state.extra[k] for k in keys]
        out["extra"] = dict(zip(keys, mine))
        out["extra_equals_rank0"] = all(
            torch.equal(a, b) for a, b in zip(mine, broadcast_from(mine, 0)))
    return out


def shards() -> dict:
    out = {"even": _shard_for_process(np.arange(12), 8),
           "uneven": _shard_for_process(np.arange(11), 8)}
    try:
        _shard_for_process(np.arange(12), 7)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def fit(inputs: dict, out_dir: Path, rank: int) -> dict:
    cfg = {"seed": 73, "pretrain": inputs["fit_cfg"]}
    train, val = get_pretrain_dataloaders(cfg, inputs["data_dir"])
    task = MAETask(inputs["model"], inputs["fit_cfg"], dtype=torch.float32, device="cpu")
    trainer = Trainer(task, 1, out_dir / f"run{rank}")
    metrics = trainer.fit(train, val)
    return {"metrics": metrics, "batch_size": train.batch_size, "steps": len(train),
            "num_examples": train.num_examples, "val_indices": val.indices,
            "train_indices": train.indices, "best_path": trainer.callbacks.best_path}


def main() -> None:
    inputs_path, out_dir = Path(sys.argv[1]), Path(sys.argv[2])
    if not maybe_initialize_distributed("cpu"):
        raise SystemExit("no process group in the environment")
    axis = get_data_axis()
    inputs = torch.load(inputs_path, weights_only=False)
    result = {"axis": (axis.size, axis.rank), "mae": step("mae", inputs, axis),
              "jepa": step("jepa", inputs, axis), "shards": shards(),
              "fit": fit(inputs, out_dir, axis.rank)}
    torch.save(result, out_dir / f"rank{axis.rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
