"""Config defaults and loading (the port's own copy of
``ssrl_vit_mae_jepa_tpu/config.py``, which imports no JAX): the reference
YAML schema, the code defaults (``DEFAULTS``, including the ``jepa``
section), ``_deep_merge``, ``load_config`` and ``save_config_snapshot``.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict

import yaml

# Code-level defaults mirroring the reference's scattered cfg.get() fallbacks
# (e.g. reference src/models/mae.py:23-36, src/training/mae.py:31-39,
# src/training/classifier.py:38-43, src/data.py:58,84-85,123,168-169).
DEFAULTS: Dict[str, Any] = {
    "seed": 73,
    "model": {
        "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
        "encoder": {"embed_dim": 144, "depth": 4, "num_heads": 6},
        "decoder": {
            "decoder_embed_dim": 192,
            "decoder_depth": 2,
            "decoder_num_heads": 6,
        },
        "head": {"embed_dim": 144, "pool": "cls"},
    },
    "pretrain": {
        "mask_ratio_start": 0.75,
        "mask_ratio_end": 0.75,
        "mask_ramp_epochs": 5,
        "total_epochs": 800,
        "warmup_epochs": 20,
        "batch_size": 2000,
        "base_learning_rate": 1.5e-4,
        "weight_decay": 0.05,
        "data_fraction": 1.0,
        "val_split": 0.06,
        "num_workers": 4,
    },
    "train": {
        "samples_per_class": 400,
        "total_epochs": 100,
        "warmup_epochs": 10,
        "batch_size": 2000,
        "learning_rate": 1e-4,
        "weight_decay": 0.05,
        "freeze_encoder": False,
        "num_workers": 4,
    },
    "jepa": {
        # New capability (BASELINE.json config 4); absent from the reference.
        "total_epochs": 800,
        "warmup_epochs": 20,
        "batch_size": 2000,
        "base_learning_rate": 1.5e-4,
        "weight_decay": 0.05,
        "data_fraction": 1.0,
        "val_split": 0.06,
        "predictor_embed_dim": 96,
        "predictor_depth": 2,
        "predictor_num_heads": 6,
        "num_target_blocks": 4,
        "target_scale": [0.15, 0.2],
        "target_aspect_ratio": [0.75, 1.5],
        "context_scale": [0.85, 1.0],
        # "complement": uniform sample of the non-target patches;
        # "block": I-JEPA contiguous square context block minus targets
        "context_sampling": "complement",
        "ema_start": 0.996,
        "ema_end": 1.0,
    },
    "test": {"batch_size": 2000, "num_workers": 4},
    "logging": {"output_dir_base": "outputs", "model_path": "vit-mae.pt"},
}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str | Path, apply_defaults: bool = True) -> Dict[str, Any]:
    """Load a YAML config, optionally merged over the code defaults."""
    with open(path, "r") as f:
        cfg = yaml.safe_load(f) or {}
    if apply_defaults:
        cfg = _deep_merge(DEFAULTS, cfg)
    return cfg



def save_config_snapshot(cfg: Dict[str, Any], output_dir: str | Path) -> Path:
    """Write the run's ``config.yaml`` into its output directory (reference
    ``scripts/training/pretrain_mae.py:62-65``)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    snapshot = output_dir / "config.yaml"
    with open(snapshot, "w") as f:
        yaml.safe_dump(cfg, f)
    return snapshot
