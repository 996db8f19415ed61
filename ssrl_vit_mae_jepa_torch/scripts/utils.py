"""Shared CLI helpers (port of ``scripts/utils.py``).

- ``device()``: the one place the CLIs read their device,
  ``$SSRL_TORCH_DEVICE`` (``cuda`` by default, or ``cpu``); under a process
  group the card is the rank's own, ``cuda:LOCAL_RANK``. With ``cuda``
  asked and no card present it raises at once: a CLI never carries on on
  the CPU unless the caller asks for it. The ablation drivers pass the
  variable on to their subprocesses with the rest of the environment.
- ``init_distributed()``: the training CLIs' first call; it joins the
  process group that ``python -m torch.distributed.run`` (or the
  ``SSRL_COORDINATOR`` variables) describe, on the device kind above.
- ``setup_reproducibility(seed)``: seeds torch and returns an explicit
  ``torch.Generator`` (the JAX helper returns a PRNG key). Nothing runs at
  import: each CLI calls it from ``main``.
- ``load_vit_classifier_from_checkpoint``: the reference's 4-path loader
  (``scripts/utils.py:41-82``) → (ClassifierTask, state dict or None).
- ``evaluate_checkpoint``: load → ``Trainer.test`` → test_acc (``:85-118``).
- ``check_ckpt_backend``: only ``native`` checkpoints are written.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

DEVICE_ENV = "SSRL_TORCH_DEVICE"
DEVICES = ("cuda", "cpu")


def device_type() -> str:
    """``$SSRL_TORCH_DEVICE``, ``cuda`` unless set."""
    name = os.environ.get(DEVICE_ENV, "cuda")
    if name not in DEVICES:
        raise ValueError(f"{DEVICE_ENV}={name!r}: expected one of {DEVICES}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: the port's CLIs run on the card by default; set "
            f"{DEVICE_ENV}=cpu to run them on the CPU")
    return name


def device() -> str:
    """The CLIs' device: :func:`device_type`, the rank's own card
    ``cuda:LOCAL_RANK`` under a process group."""
    from ssrl_vit_mae_jepa_torch.parallel.multihost import is_initialized, local_rank

    name = device_type()
    if name == "cuda" and is_initialized():
        return f"cuda:{local_rank()}"
    return name


def init_distributed() -> bool:
    """Join the process group the environment describes, if any
    (``parallel/multihost.py::maybe_initialize_distributed``)."""
    from ssrl_vit_mae_jepa_torch.parallel.multihost import (
        maybe_initialize_distributed,
        rank,
        world_size,
    )

    if not maybe_initialize_distributed(device_type()):
        return False
    print(f"Data parallel: rank {rank()} of {world_size()} on {device()}", flush=True)
    return True


def setup_reproducibility(seed: int = 73) -> torch.Generator:
    """Seed torch's global generators and return a generator seeded ``seed``."""
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def shut_down_warnings() -> None:
    import warnings

    warnings.filterwarnings("ignore", category=FutureWarning)


def check_ckpt_backend(log_cfg: dict) -> None:
    """``logging.ckpt_backend`` must be ``native`` (the default)."""
    backend = log_cfg.get("ckpt_backend", "native")
    if backend != "native":
        raise ValueError(
            f"logging.ckpt_backend={backend!r}: the port writes only its native torch "
            "checkpoints; orbax is a JAX format that it does not write")


def load_vit_classifier_from_checkpoint(
    model_cfg: dict,
    training_cfg: dict,
    checkpoint_path: Optional[str | Path] = None,
    encoder_only: bool = False,
    augment: bool = True,
):
    """4-path classifier loading → (ClassifierTask, state dict or None):
    None → random init; a full classifier checkpoint (the port's ``.ckpt``,
    the reference's Lightning ``.ckpt``, a ``.pt`` or a JAX-native
    checkpoint); an encoder-only checkpoint with prefix detection
    (``encoder_only``)."""
    from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask
    from ssrl_vit_mae_jepa_torch.utils.load import (
        classifier_params_from_checkpoint,
        encoder_params_from_checkpoint,
        merge_encoder,
    )

    print(f"Loading ViTClassifier from checkpoint: {checkpoint_path}")
    task = ClassifierTask(model_cfg, training_cfg, augment=augment,
                          device=device())
    depth = model_cfg["encoder"]["depth"]
    if checkpoint_path is None:
        print("Classifier randomly initialized")
        return task, None
    if encoder_only:
        enc, _ = encoder_params_from_checkpoint(checkpoint_path, depth)
        task.model.init_weights(torch.Generator().manual_seed(0))
        print("Loaded encoder-only weights")
        return task, merge_encoder(task.model.state_dict(), enc)
    params, report, _meta = classifier_params_from_checkpoint(checkpoint_path, depth)
    if report["missing"]:
        print(f"Missing keys in checkpoint: {report['missing'][:5]} ...")
    print("Loaded full classifier weights")
    return task, params


def evaluate_checkpoint(cfg: dict, checkpoint_path: str | Path, test_loader):
    """Load a classifier checkpoint and evaluate it on ``test_loader`` →
    test accuracy (top-5 printed beside it)."""
    from ssrl_vit_mae_jepa_torch.training.trainer import Trainer

    test_cfg = cfg["test"]
    log_cfg = cfg["logging"]
    task, params = load_vit_classifier_from_checkpoint(
        model_cfg=cfg["model"], training_cfg=cfg["train"],
        checkpoint_path=checkpoint_path, encoder_only=False)
    output_dir = (Path(log_cfg["output_dir_base"]) / "test"
                  / test_cfg.get("output_dir_suffix", "default"))
    trainer = Trainer(task, max_epochs=0, output_dir=output_dir)
    trainer.init_state()
    if params is not None:
        trainer.load_params_into_state(params)
    print("\nStarting evaluation...")
    results = trainer.test(test_loader)
    acc = results.get("test_acc")
    print(f"Test Accuracy: {acc}")
    if "test_top5" in results:
        print(f"Test Top-5 Accuracy: {results['test_top5']}")
    return acc
