"""Shared machinery for the ablation sweep drivers.

Port of ``scripts/ablation/common.py``. ``launch`` starts the port's CLIs,
whose processes inherit the environment (``SSRL_TORCH_DEVICE`` with it).

The three drivers (``run_pretrain_ablation``, ``run_train_ablation``,
``run_baseline_ablation``) are declarative grids over the same primitive: derive
a config from the base YAML, write it to disk, and launch one training CLI in a
fresh subprocess. This module holds that primitive so each driver is just its
grid plus chaining rules.

Behavioral contract implemented here (SURVEY.md §3.4):
  * one fresh Python process per run (process boundary between sweep cells);
  * a run is "done" iff ``<outputs>/<kind>/<suffix>/checkpoints/best.ckpt``
    exists — done runs are skipped so a sweep is resumable by re-running it;
  * derived configs are deep copies of the base config (nested-dict mutations
    must never leak across sweep cells — reference quirk Q9).

Grids are overridable through environment variables (``SSRL_ABLATION_CONFIG``,
``SSRL_ABLATION_FRACTIONS``, ``SSRL_ABLATION_LABELS``) so the end-to-end test
can shrink them to a single cell.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
from pathlib import Path

import yaml


def base_config_path() -> Path:
    return Path(os.environ.get("SSRL_ABLATION_CONFIG", "configs/mae.yaml"))


def load_base_config() -> dict:
    path = base_config_path()
    if not path.exists():
        raise FileNotFoundError(f"Base ablation config not found: {path}")
    return yaml.safe_load(path.read_text())


def grid_from_env(var: str, default: str, cast) -> list:
    """Read a comma-separated sweep axis from the environment."""
    return [cast(tok) for tok in os.environ.get(var, default).split(",")]


def derive_config(base: dict, section: str, overrides: dict) -> dict:
    """Deep-copy ``base`` and apply ``overrides`` to one section.

    An override value of ``None`` removes the key (used to drop
    ``unfreeze_last_layers`` for modes that must not carry it).
    """
    cfg = copy.deepcopy(base)
    target = cfg.setdefault(section, {})
    for key, value in overrides.items():
        if value is None:
            target.pop(key, None)
        else:
            target[key] = value
    return cfg


def write_config(cfg: dict, path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def outputs_root(cfg: dict) -> Path:
    return Path(cfg.get("logging", {}).get("output_dir_base", "outputs"))


def best_checkpoint(cfg: dict, kind: str, suffix: str) -> Path:
    """Where the training CLIs put the best checkpoint for a given run."""
    return outputs_root(cfg) / kind / suffix / "checkpoints" / "best.ckpt"


def launch(module: str, config_path: Path, suffix: str,
           extra_args: tuple[str, ...] = ()) -> int:
    """Run one training CLI in a subprocess; return its exit code."""
    cmd = [
        sys.executable, "-m", module,
        "--config", str(config_path),
        "--output_dir_suffix", suffix,
        *extra_args,
    ]
    print(f"[ablation] launching: {' '.join(cmd)}", flush=True)
    return subprocess.run(cmd).returncode
