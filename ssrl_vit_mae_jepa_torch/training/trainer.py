"""Training engine: epoch loops, eval, checkpoints, logging, resume, on one
card or data-parallel over the default process group.

Port of ``ssrl_vit_mae_jepa_tpu/training/trainer.py`` (the replacement for
``pytorch_lightning.Trainer`` as the reference uses it,
``scripts/training/pretrain_mae.py:116-128``): ``fit`` runs the epochs with
the task's per-epoch context and its ``on_fit_start``, keeps the metric
sums on the device and syncs with the host once per epoch, evaluates,
logs (``metrics.jsonl``) and applies the best / last / periodic checkpoint
policy; ``evaluate`` draws each eval batch's masks from a generator seeded
by ``EVAL_RNG_SEED`` and ``epoch * 100003 + i``; ``test``, ``save``,
resume and ``load_params_into_state`` follow the JAX trainer. The
checkpoints follow the task's monitor (``val_loss``/min for pretraining,
``val_acc``/max for the classifier) and keep the best and the last epoch.

``log_every_n_steps`` adds a record of the step's own train metrics every
n global steps (one host sync each; off by default, so an epoch syncs once)
and ``periodic_ckpt_every`` the weights-only ``epoch-NNN.ckpt`` files, as the
JAX trainer does (:153-165, ``CheckpointCallbacks(periodic_every=)``).

Data parallelism (``trainer.py:60-68``, ``:111-118``, ``:186`` of the JAX
package): under a process group the task's steps run over the data axis
(``Task.configure_sharding``), each rank's loader holds its own shard at the
per-rank batch (``data/loaders.py``, which refuses a global batch that the
world size does not divide), so the global batch is the per-rank batch
times the world size and ``images_per_s`` counts every rank; the
metrics are all-reduced, so every rank takes the same checkpoint decision,
but only rank 0 writes checkpoints, ``metrics.jsonl`` and the TensorBoard
logs (``logger`` is None on the others). A resume loads the same file on
every rank.

Tensor parallelism (``trainer.py:93-95`` there): ``Trainer(mesh=)`` takes
the (data, model) grid of ``parallel/mesh.py::get_mesh`` (by default
``get_mesh()``, data parallelism over the default group); the task makes
the full weights from the seed on every rank and keeps its shards. The
checkpoints hold full tensors: ``save`` gathers the params, the Adam moments
and JEPA's EMA target (the model ranks of rank 0's row take part), and a
resume gathers the state, restores it and cuts it again. ``world`` and
``images_per_s`` count data ranks, not processes.

A resume takes the port's checkpoints and the JAX package's native trainer
checkpoints (``utils/checkpoint.py::restore_native_state``). Not ported: the
orbax checkpoint backend, a JAX format (the CLIs refuse ``ckpt_backend:
orbax``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from ssrl_vit_mae_jepa_torch.data.pipeline import HostLoader, device_prefetch
from ssrl_vit_mae_jepa_torch.parallel import multihost
from ssrl_vit_mae_jepa_torch.parallel.mesh import Grid, get_mesh, shard_params
from ssrl_vit_mae_jepa_torch.training.state import TrainState
from ssrl_vit_mae_jepa_torch.training.tasks import Task
from ssrl_vit_mae_jepa_torch.utils.checkpoint import (
    CheckpointCallbacks,
    gather_state_,
    gathered_payload,
    load_checkpoint,
    restore_native_state,
    restore_state,
    save_checkpoint,
    shard_state_,
    state_payload,
)
from ssrl_vit_mae_jepa_torch.utils.flax_msgpack import is_native_zip
from ssrl_vit_mae_jepa_torch.utils.metrics_logger import MetricsLogger

EVAL_RNG_SEED = 4242


def eval_generator(device: torch.device, epoch: int, i: int) -> torch.Generator:
    """The generator of eval batch ``i`` at ``epoch`` (the JAX trainer's
    ``fold_in(PRNGKey(EVAL_RNG_SEED), epoch * 100003 + i)``)."""
    return torch.Generator(device).manual_seed(EVAL_RNG_SEED * 2**32 + epoch * 100003 + i)


def _add(sums: Optional[Dict], step_sums: Dict) -> Dict:
    if sums is None:
        return dict(step_sums)
    return {k: sums[k] + v for k, v in step_sums.items()}


def _host(sums: Optional[Dict]) -> Dict[str, float]:
    """The sums as floats, with one host sync for all the tensors."""
    sums = sums or {}
    out = {k: float(v) for k, v in sums.items() if not torch.is_tensor(v)}
    keys = [k for k, v in sums.items() if torch.is_tensor(v)]
    if keys:
        out.update(zip(keys, torch.stack([sums[k].double() for k in keys]).cpu().tolist()))
    return out


class Trainer:
    def __init__(self, task: Task, max_epochs: int, output_dir: str | Path, seed: int = 73,
                 hyper_parameters: Optional[Dict[str, Any]] = None,
                 log_every_n_steps: Optional[int] = None,
                 periodic_ckpt_every: Optional[int] = None,
                 mesh: Optional[Grid] = None):
        self.task = task
        self.max_epochs = max_epochs
        self.output_dir = Path(output_dir)
        self.mesh = mesh if mesh is not None else get_mesh()
        task.configure_sharding(self.mesh)
        self.axis = self.mesh.data
        #: the data ranks (the global batch is the loader's batch times this)
        self.world = 1 if self.axis is None else self.axis.size
        #: rank 0, the one process that writes files
        self.is_main = multihost.rank() == 0
        #: whether this rank takes part in making the checkpoints' payload:
        #: rank 0 and, over a model axis, the rest of its model row (gathers)
        self._payloads = self.is_main or (task.model_axis is not None and self.axis.rank == 0)
        self.seed = seed
        self.log_every_n_steps = log_every_n_steps
        self.logger = MetricsLogger(self.output_dir) if self.is_main else None
        self.hyper_parameters = hyper_parameters or {}
        self.callbacks = CheckpointCallbacks(self.output_dir / "checkpoints",
                                             monitor=task.monitor, mode=task.monitor_mode,
                                             periodic_every=periodic_ckpt_every)
        self.state: Optional[TrainState] = None
        self.global_step = 0

    def init_state(self, init_params_override: Optional[Callable] = None) -> TrainState:
        self.state = self.task.init_state(self.seed, init_params_override)
        return self.state

    def _batches(self, loader: HostLoader, epoch: int):
        return device_prefetch(loader.epoch(epoch), self.task.device,
                               depth=getattr(loader, "prefetch_depth", 2))

    def fit(self, train_loader: HostLoader, val_loader: Optional[HostLoader] = None,
            resume_from: Optional[str | Path] = None,
            init_params_override: Optional[Callable] = None) -> Dict[str, float]:
        if self.state is None:
            self.init_state(init_params_override)
        self.task.on_fit_start(len(train_loader))
        start_epoch = 0
        if resume_from is not None:
            start_epoch = self._resume(resume_from)
        last_metrics: Dict[str, float] = {}
        for epoch in range(start_epoch, self.max_epochs):
            ctx = self.task.epoch_context(epoch)
            host_metrics = self.task.host_epoch_metrics(epoch)
            t0 = time.time()
            sums = None
            n_steps = 0
            for batch in self._batches(train_loader, epoch):
                self.state, step_sums = self.task.train_step(self.state, batch, epoch, ctx)
                sums = _add(sums, step_sums)
                n_steps += 1
                self.global_step += 1
                if (self.logger is not None and self.log_every_n_steps
                        and self.global_step % self.log_every_n_steps == 0):
                    self.logger.log(
                        self.task.epoch_metrics_from_sums(_host(step_sums), "train"),
                        step=self.global_step, epoch=epoch)
            sums = _host(sums)  # one host sync per epoch
            dt = time.time() - t0
            metrics = {**host_metrics, **self.task.epoch_metrics_from_sums(sums, "train")}
            if "lr" in sums and n_steps:
                metrics["lr"] = sums["lr"] / n_steps  # constant per epoch
            if val_loader is not None and len(val_loader) > 0:
                metrics.update(self.evaluate(val_loader, prefix="val", epoch=epoch, ctx=ctx))
            metrics["epoch_time_s"] = dt
            # real examples only: the padded rows of the last batch (weight
            # 0) do not count; every rank's loader holds its own shard
            metrics["images_per_s"] = train_loader.num_examples * self.world / max(dt, 1e-9)
            if self.logger is not None:
                self.logger.log(metrics, step=self.global_step, epoch=epoch)
            shown = {k: round(v, 5) for k, v in metrics.items()
                     if k not in ("epoch_time_s", "images_per_s")}
            print(f"Epoch {epoch}: {n_steps} steps, {dt:.1f}s, "
                  f"{metrics['images_per_s']:.0f} img/s - {shown}", flush=True)
            payload = self._payload() if self._payloads else None
            if self.is_main:
                self.callbacks.on_epoch_end(
                    epoch, metrics, payload,
                    meta_base={"global_step": self.global_step,
                               "hyper_parameters": self.hyper_parameters})
                self.logger.flush()
            else:
                self.callbacks.record_epoch(epoch, metrics)
            last_metrics = metrics
        return last_metrics

    def evaluate(self, loader: HostLoader, prefix: str = "val", epoch: int = 0,
                 ctx=None) -> Dict[str, float]:
        """The task's epoch metrics of ``loader`` under the current state."""
        if ctx is None:
            ctx = self.task.epoch_context(epoch)
        sums = None
        for i, batch in enumerate(self._batches(loader, 0)):
            gen = eval_generator(self.task.device, epoch, i)
            sums = _add(sums, self.task.eval_step(self.state, batch, gen, ctx))
        if sums is None:
            # epoch_metrics_from_sums({}) would report a perfect 0.0 loss
            raise ValueError(
                f"evaluate() got an empty loader (prefix={prefix!r}): no batches "
                "were produced; check data_dir/fraction/split")
        return self.task.epoch_metrics_from_sums(_host(sums), prefix)

    def test(self, loader: HostLoader, params: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, float]:
        """The reference's ``trainer.test`` → {"test_loss", "test_acc", ...};
        ``params`` (a state dict) are loaded into the state first, and the
        task's extra state (JEPA's target) starts from them as in training."""
        if params is not None:
            self.load_params_into_state(params)
            extra = self.task.init_extra(self.state.params)
            if extra is not None:
                self.state.extra = extra
        elif self.state is None:
            self.init_state()
        return self.evaluate(loader, prefix="test")

    def save(self, path: str | Path) -> Optional[Path]:
        """The whole state as a checkpoint that resumes (``fit(resume_from=)``),
        written by rank 0 (None on the others); over a model axis every rank
        calls it (rank 0's model row gathers the shards)."""
        payload = self._payload() if self._payloads else None
        if not self.is_main:
            return None
        return save_checkpoint(path, payload, {"hyper_parameters": self.hyper_parameters,
                                               "global_step": self.global_step})

    def _payload(self) -> Dict[str, Any]:
        """The checkpoint's tensors, full ones over a model axis."""
        tp = self.task.model_axis
        if tp is None:
            return state_payload(self.state, self.task.model.state_dict(), self.task.tx)
        return gathered_payload(self.state, self.task.model.state_dict(), self.task.tx, tp)

    def _resume(self, path: str | Path) -> int:
        """Restore the state from the port's checkpoint or the JAX package's
        native trainer checkpoint; returns the epoch to go on from. Over a
        model axis the state is full while it is restored, then cut again."""
        tp = self.task.model_axis
        if tp is not None:
            gather_state_(self.state, self.task.tx, tp)
        if is_native_zip(path):
            ckpt = restore_native_state(path, self.state, self.task.model, self.task.tx,
                                        self.task.flax_params_to_state)
        else:
            ckpt = load_checkpoint(path)
            restore_state(ckpt, self.state, self.task.model, self.task.tx)
        if tp is not None:
            shard_state_(self.state, self.task.tx, tp)
        self.global_step = int(ckpt.get("global_step", 0))
        self.callbacks.best_score = ckpt.get("callbacks", {}).get("best_model_score")
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        print(f"Resumed from {path} at epoch {start_epoch}")
        return start_epoch

    @torch.no_grad()
    def load_params_into_state(self, params: Dict[str, torch.Tensor]) -> TrainState:
        """Replace the model's weights (a state dict), with fresh optimizer
        state."""
        if self.state is None:
            self.init_state()
        self.task.model.load_state_dict(shard_params(params, self.task.model_axis), strict=True)
        self.state.opt_state = self.task.tx.init(self.state.params)
        return self.state
