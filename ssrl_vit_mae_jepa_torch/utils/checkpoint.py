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

``restore_native_state`` resumes from the JAX package's own trainer
checkpoint (flax msgpack in a zip, read by ``utils/flax_msgpack.py``), as
the JAX trainer does (``training/trainer.py:276-291`` there): the params
and Adam's moments through the task's relayout of ``utils/interop.py``,
JEPA's EMA target through the encoder's, count, rate, step, and the
``meta.json`` that holds epoch, global step and best score. A threefry key
has no torch generator state: the generator is seeded from its two words.

A checkpoint always holds full tensors. Over a model axis
(``parallel/mesh.py``) ``gathered_payload`` gathers the shards of the
params, the moments and the EMA target before the payload is made, and
``gather_state_`` / ``shard_state_`` take a state to full tensors and back
in place around a restore, so a file written by a grid and one written by
one process load alike in either.
"""

from __future__ import annotations

import os
from dataclasses import replace
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.parallel.mesh import ModelAxis, gather_params, shard_params
from ssrl_vit_mae_jepa_torch.training.optim import AdamW
from ssrl_vit_mae_jepa_torch.training.state import TrainState
from ssrl_vit_mae_jepa_torch.utils.flax_msgpack import read_native_checkpoint
from ssrl_vit_mae_jepa_torch.utils.interop import vit_params_to_state
from ssrl_vit_mae_jepa_torch.utils.load import numpy_tree

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


def _moments(state: TrainState, tx: AdamW):
    names = tx.trainable(state.params)
    return dict(zip(names, state.opt_state.mu)), dict(zip(names, state.opt_state.nu))


def gathered_payload(state: TrainState, model_state: Dict[str, torch.Tensor], tx: AdamW,
                     axis: ModelAxis) -> Dict[str, Any]:
    """:func:`state_payload` of the full state of which this rank holds a
    shard over ``axis``: every rank of the model group must call it (the
    gathers are all-reduces over the group)."""
    mu, nu = _moments(state, tx)
    mu, nu = gather_params(mu, axis), gather_params(nu, axis)
    opt = replace(state.opt_state, mu=list(mu.values()), nu=list(nu.values()))
    extra = None if state.extra is None else gather_params(state.extra, axis)
    full = replace(state, opt_state=opt, extra=extra)
    return state_payload(full, gather_params(model_state, axis), tx)


def _set_data(tensors: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    for k, t in tensors.items():
        t.data = new[k]


@torch.no_grad()
def gather_state_(state: TrainState, tx: AdamW, axis: ModelAxis) -> None:
    """The params (so the model's own), moments and EMA target of ``state``
    as full tensors, in place (the tensor objects stay): a collective over
    the model group."""
    for group in (state.params, *_moments(state, tx), state.extra or {}):
        _set_data(group, gather_params(group, axis))


@torch.no_grad()
def shard_state_(state: TrainState, tx: AdamW, axis: ModelAxis) -> None:
    """``gather_state_`` undone: this rank's shards again, in place."""
    for group in (state.params, *_moments(state, tx), state.extra or {}):
        _set_data(group, shard_params(group, axis))


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


WEIGHTS_ONLY = "a weights-only checkpoint cannot resume training"


def _check_covers(names, trainable) -> None:
    if names != trainable:
        raise ValueError(f"the checkpoint's optimizer covers {len(names)} tensors, "
                         f"the task trains {len(trainable)}")


@torch.no_grad()
def restore_state(ckpt: Dict[str, Any], state: TrainState, model: torch.nn.Module,
                  tx: AdamW) -> TrainState:
    """Load a full checkpoint into ``model`` and ``state`` in place: the
    parameters, the optimizer's moments (which must cover the names ``tx``
    trains), count and lr, the generator, the extra state and the step."""
    if "optimizer" not in ckpt:
        raise ValueError(WEIGHTS_ONLY)
    model.load_state_dict(model_state(ckpt), strict=True)
    opt = ckpt["optimizer"]
    names = list(opt["mu"])
    _check_covers(names, tx.trainable(state.params))
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


def _adam_node(tree) -> Optional[dict]:
    """optax's ``ScaleByAdamState`` in a serialized ``opt_state``: the map
    with ``count``, ``mu`` and ``nu``, wherever the chain put it
    (``inner_state/1/0``, or ``inner_state/inner_state/1/0`` under
    ``optax.masked``)."""
    if not isinstance(tree, dict):
        return None
    if {"count", "mu", "nu"} <= tree.keys():
        return tree
    for v in tree.values():
        found = _adam_node(v)
        if found is not None:
            return found
    return None


# ``optax.masked`` keeps a ``MaskedNode`` for each frozen leaf of a moment,
# which flax serializes as an empty map
def _trainable_flags(params, moment):
    """The params' tree with ones where the moment holds an array, zeros
    where the leaf is frozen: mapped like params, it names the trainable
    tensors."""
    if isinstance(params, dict):
        return {k: _trainable_flags(v, moment[k]) for k, v in params.items()}
    return np.full(params.shape, 0.0 if isinstance(moment, dict) else 1.0, np.float32)


def _filled(params, moment):
    """The moment's tree with zeros of the parameter's shape at frozen leaves."""
    if isinstance(params, dict):
        return {k: _filled(v, moment[k]) for k, v in params.items()}
    return np.zeros_like(params) if isinstance(moment, dict) else moment


@torch.no_grad()
def restore_native_state(path: str | Path, state: TrainState, model: torch.nn.Module,
                         tx: AdamW, params_to_state: Callable[[dict], Dict[str, np.ndarray]]
                         ) -> Dict[str, Any]:
    """Load a JAX-native trainer checkpoint into ``model`` and ``state`` in
    place, as :func:`restore_state` does for the port's own; returns its
    ``meta.json``. ``params_to_state`` is the task's flax → port relayout
    (``utils/interop.py``); the moments have the params' tree, so it maps
    them too. Tensors the optimizer leaves frozen must be the ones ``tx``
    leaves frozen."""
    tree, meta = read_native_checkpoint(path)
    if not isinstance(tree, dict) or "opt_state" not in tree:
        raise ValueError(WEIGHTS_ONLY)
    params = numpy_tree(tree["params"])
    adam = _adam_node(tree["opt_state"])
    if adam is None:
        raise ValueError(f"{path}: no Adam state (count, mu, nu) in its opt_state")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params_to_state(params).items()},
                          strict=True)
    flags = params_to_state(_trainable_flags(params, adam["mu"]))
    names = [k for k in state.params if flags[k].all()]
    _check_covers(names, tx.trainable(state.params))
    for dst, key in ((state.opt_state.mu, "mu"), (state.opt_state.nu, "nu")):
        moments = params_to_state(_filled(params, numpy_tree(adam[key])))
        for t, k in zip(dst, names):
            t.copy_(torch.from_numpy(moments[k]))
    # in place: a captured step (``Task.train_steps_fused``) reads these tensors
    state.opt_state.learning_rate.fill_(float(tree["opt_state"]["hyperparams"]["learning_rate"]))
    state.opt_state.count.fill_(int(adam["count"]))
    w0, w1 = (int(w) for w in tree["rng"].numpy())
    state.generator.manual_seed((w0 << 32) | w1)
    if (tree.get("extra") is None) != (state.extra is None):
        raise ValueError(f"{path}: extra state {'absent' if state.extra is not None else 'present'}"
                         ", unlike the task's")
    if state.extra is not None:
        target = vit_params_to_state(numpy_tree(tree["extra"]))
        for k, t in state.extra.items():
            t.copy_(torch.from_numpy(target[k]))
    state.step = int(tree["step"])
    return meta


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

