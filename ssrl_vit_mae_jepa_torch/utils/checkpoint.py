"""Checkpoint IO: Lightning-style torch ``.ckpt`` files and the best / last /
periodic policy.

Port of ``ssrl_vit_mae_jepa_tpu/utils/checkpoint.py``. The JAX package's own
format is flax msgpack in a zip, which needs flax; the port writes instead
the torch ``.ckpt`` layout that the JAX package already reads
(``utils/torch_interop.py::load_torch_state_dict`` unwraps ``state_dict``),
so either package loads the other's weights:

- ``state_dict``: the model's tensors by the reference's timm/lightly names,
  under ``model.`` (Lightning's module prefix);
- ``optimizer``: the AdamW moments by parameter name, its step ``count``
  and ``learning_rate`` as Python numbers (absent from weights-only files);
- ``generator``: the device generator's state and its device type;
- ``extra``: the task's state that is not a parameter (JEPA's EMA target,
  by the encoder's names), and ``step``, the train state's step counter;
- ``epoch``, ``global_step``, ``callbacks`` (``monitor``, ``mode``,
  ``best_model_score``), ``metrics``, ``hyper_parameters`` and
  ``weights_only``, as the JAX package's ``meta.json`` holds them.

Saves are atomic: a temp file beside the target, then ``os.replace``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ssrl_vit_mae_jepa_torch.training.optim import AdamW
from ssrl_vit_mae_jepa_torch.training.state import TrainState

FORMAT_KEY = "ssrl_vit_mae_jepa_torch"
FORMAT_VERSION = 1
MODEL_PREFIX = "model."


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def state_payload(state: TrainState, model_state: Dict[str, torch.Tensor],
                  tx: AdamW) -> Dict[str, Any]:
    """The tensors of a checkpoint, on the host: the model's state dict
    under ``model.``, the optimizer's state by the names ``tx`` trains, the
    generator, the extra state and the step."""
    out: Dict[str, Any] = {
        "state_dict": {MODEL_PREFIX + k: v for k, v in _host(model_state).items()}}
    opt = state.opt_state
    names = tx.trainable(state.params)
    out["optimizer"] = {
        "learning_rate": float(opt.learning_rate), "count": int(opt.count),
        "mu": _host(dict(zip(names, opt.mu))), "nu": _host(dict(zip(names, opt.nu))),
    }
    out["generator"] = {"device": state.generator.device.type,
                        "state": state.generator.get_state()}
    out["extra"] = None if state.extra is None else _host(state.extra)
    out["step"] = int(state.step)
    return out


def save_checkpoint(path: str | Path, payload: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None) -> Path:
    """Atomically write ``payload`` (from :func:`state_payload`) with
    ``meta`` as one torch file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {**dict(meta or {}), **payload,
            "__format__": FORMAT_KEY, "__version__": FORMAT_VERSION}
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(blob, str(tmp))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """The whole checkpoint, tensors on the CPU."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict) or ckpt.get("__format__") != FORMAT_KEY:
        raise ValueError(f"{path} is not a {FORMAT_KEY} checkpoint")
    return ckpt


def model_state(ckpt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The model's state dict of a checkpoint, without the ``model.`` prefix."""
    return {k[len(MODEL_PREFIX):]: v for k, v in ckpt["state_dict"].items()
            if k.startswith(MODEL_PREFIX)}


@torch.no_grad()
def restore_state(ckpt: Dict[str, Any], state: TrainState, model: torch.nn.Module,
                  tx: AdamW) -> TrainState:
    """Load a full checkpoint into ``model`` and ``state`` in place: the
    parameters, the optimizer's moments (which must cover the names ``tx``
    trains), count and lr, the generator, the extra state and the step."""
    if "optimizer" not in ckpt:
        raise ValueError("a weights-only checkpoint cannot resume training")
    model.load_state_dict(model_state(ckpt), strict=True)
    opt = ckpt["optimizer"]
    names = list(opt["mu"])
    trainable = tx.trainable(state.params)
    if names != trainable:
        raise ValueError(f"the checkpoint's optimizer covers {len(names)} tensors, "
                         f"the task trains {len(trainable)}")
    for dst, key in ((state.opt_state.mu, "mu"), (state.opt_state.nu, "nu")):
        for t, k in zip(dst, names):
            t.copy_(opt[key][k])
    # in place: a captured step (``Task.train_steps_fused``) reads these tensors
    state.opt_state.learning_rate.fill_(float(opt["learning_rate"]))
    state.opt_state.count.fill_(int(opt["count"]))
    if ckpt["generator"]["device"] != state.generator.device.type:
        raise ValueError(f"the checkpoint's generator is on {ckpt['generator']['device']}, "
                         f"the task's on {state.generator.device.type}")
    state.generator.set_state(ckpt["generator"]["state"])
    if state.extra is not None:
        for k, t in state.extra.items():
            t.copy_(ckpt["extra"][k])
    state.step = int(ckpt["step"])
    return state


class CheckpointCallbacks:
    """best / last / periodic checkpoint policy (``utils/checkpoint.py:112-238``
    of the JAX package, reference ``pretrain_mae.py:85-109``) with the
    monitor asymmetry of quirk Q10: pretraining follows ``val_loss``/min,
    supervised training ``val_acc``/max. Periodic files are weights-only."""

    def __init__(self, ckpt_dir: str | Path, monitor: str = "val_loss", mode: str = "min",
                 periodic_every: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"unknown monitor mode {mode!r}")
        self.ckpt_dir = Path(ckpt_dir)
        self.monitor = monitor
        self.mode = mode
        self.periodic_every = periodic_every
        self.best_score: Optional[float] = None
        self.best_path: Optional[Path] = None

    def _improved(self, score: float) -> bool:
        if self.best_score is None:
            return True
        return score < self.best_score if self.mode == "min" else score > self.best_score

    def record_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        """``on_epoch_end``'s bookkeeping without the files, for the ranks
        other than 0: the metrics are all-reduced, so ``best_score`` and
        ``best_path`` follow rank 0's."""
        score = metrics.get(self.monitor)
        if score is not None and self._improved(float(score)):
            self.best_score = float(score)
            self.best_path = self.ckpt_dir / "best.ckpt"

    def on_epoch_end(self, epoch: int, metrics: Dict[str, float], full: Dict[str, Any],
                     meta_base: Dict[str, Any]) -> Dict[str, Any]:
        """Apply the policies to ``full``, the epoch's :func:`state_payload`
        (on the host once, shared by every file written); returns
        ``{"saved": [paths...]}``."""
        saved = []
        score = metrics.get(self.monitor)
        meta = dict(meta_base)
        meta.update({
            "epoch": epoch,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "callbacks": {"monitor": self.monitor, "mode": self.mode,
                          "best_model_score": self.best_score},
            "weights_only": False,
        })
        if score is not None and self._improved(float(score)):
            self.best_score = float(score)
            meta["callbacks"]["best_model_score"] = self.best_score
            self.best_path = save_checkpoint(self.ckpt_dir / "best.ckpt", full, meta)
            saved.append(self.best_path)
        saved.append(save_checkpoint(self.ckpt_dir / "last.ckpt", full, meta))
        if self.periodic_every and (epoch + 1) % self.periodic_every == 0:
            saved.append(save_checkpoint(
                self.ckpt_dir / f"epoch-{epoch:03d}.ckpt",
                {"state_dict": full["state_dict"]}, {**meta, "weights_only": True}))
        return {"saved": saved}

