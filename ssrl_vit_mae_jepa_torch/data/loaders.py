"""Dataloader factories matching the reference's ``src/data.py`` API.

Port of ``ssrl_vit_mae_jepa_tpu/data/loaders.py``:
``get_pretrain_dataloaders`` / ``get_train_dataloaders`` /
``get_test_dataloader`` (reference ``src/data.py:45,109,167``) with the same
split indices (seed 73 by default, quirk Q4's first-n fraction, quirk Q5's
per-class RNG reset; see ``data/stl10.py``). The loaders move uint8 pixels
only; augmentation runs on the device in the task. The batch size in the
config is the global batch: under a process group each rank's loader
holds its own contiguous shard of the indices at ``batch_size // world``
rows (``_shard_for_process``), ``world`` counting data ranks (under a
model axis the processes of one model row read the same rows); one process
takes them all.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np

from ssrl_vit_mae_jepa_torch.data.pipeline import HostLoader
from ssrl_vit_mae_jepa_torch.data.stl10 import (
    STL10,
    pretrain_split_indices,
    stratified_split_indices,
)
from ssrl_vit_mae_jepa_torch.parallel.multihost import data_world_size, process_local_indices

ROOT_DIR = Path(__file__).resolve().parents[2]


def default_data_dir() -> Path:
    """``$SSRL_DATA_DIR``, read at each call (so an in-process caller may set
    it), else ``data/`` at the repository root."""
    return Path(os.environ.get("SSRL_DATA_DIR", ROOT_DIR / "data"))


def _shard_for_process(indices: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """This rank's index shard and batch size (``loaders.py:33-57`` of the
    JAX package): a disjoint contiguous shard (wrap-around padded, so every
    rank takes as many batches) at ``batch_size // world`` rows, so that
    the ranks together feed the global batch; ``world`` and the shard are
    the data axis's (``multihost.data_world_size``), so the model ranks of
    one data rank hold the same shard; one process is the identity."""
    pc = data_world_size()
    if pc == 1:
        return indices, batch_size
    if batch_size % pc:
        raise ValueError(f"global batch_size {batch_size} not divisible by process_count {pc}")
    return process_local_indices(indices), batch_size // pc


def _depth(section: dict) -> int:
    """Batches in flight, from the reference's ``num_workers`` knob."""
    return max(2, section.get("num_workers", 4) // 2)


def get_pretrain_dataloaders(cfg: dict, data_dir: str | Path | None = None
                             ) -> Tuple[HostLoader, HostLoader]:
    """Unlabeled STL-10 → (train, val) loaders (reference ``src/data.py:45-106``)."""
    pre_cfg = cfg["pretrain"]
    seed = cfg.get("seed", 73)
    ds = STL10(data_dir or default_data_dir(), split="unlabeled")
    train_idx, val_idx = pretrain_split_indices(
        len(ds), pre_cfg.get("data_fraction", 1.0), pre_cfg.get("val_split", 0.1), seed)
    global_bs = pre_cfg.get("batch_size", 512)
    train_idx, batch_size = _shard_for_process(train_idx, global_bs)
    val_idx, _ = _shard_for_process(val_idx, global_bs)
    train = HostLoader(ds, train_idx, batch_size, shuffle=True, seed=seed)
    val = HostLoader(ds, val_idx, batch_size, shuffle=False, seed=seed)
    train.prefetch_depth = val.prefetch_depth = _depth(pre_cfg)
    print(f"Unlabeled pretrain split: {len(train_idx)} train, {len(val_idx)} val "
          f"({pre_cfg.get('val_split', 0.1) * 100:.1f}% validation)")
    return train, val


def get_train_dataloaders(cfg: dict, data_dir: str | Path | None = None
                          ) -> Tuple[HostLoader, HostLoader]:
    """Labeled STL-10 → (train, val) loaders (reference ``src/data.py:109-164``)."""
    train_cfg = cfg["train"]
    seed = cfg.get("seed", 73)
    ds = STL10(data_dir or default_data_dir(), split="train")
    samples_per_class = train_cfg.get("samples_per_class", 400)
    train_idx, val_idx = stratified_split_indices(np.asarray(ds.labels), samples_per_class,
                                                  seed)
    print(f"Using {samples_per_class} samples/class: {len(train_idx)} train, "
          f"{len(val_idx)} val")
    train_idx, batch_size = _shard_for_process(train_idx, train_cfg.get("batch_size", 256))
    val_idx, _ = _shard_for_process(val_idx, train_cfg.get("batch_size", 256))
    train = HostLoader(ds, train_idx, batch_size, shuffle=True, seed=seed)
    val = HostLoader(ds, val_idx, batch_size, shuffle=False, seed=seed)
    train.prefetch_depth = val.prefetch_depth = _depth(train_cfg)
    return train, val


def get_test_dataloader(cfg: dict, data_dir: str | Path | None = None) -> HostLoader:
    """STL-10 test split loader (reference ``src/data.py:167-185``)."""
    test_cfg = cfg.get("test", {})
    ds = STL10(data_dir or default_data_dir(), split="test")
    print(f"Loaded STL-10 test split: {len(ds)} samples")
    idx, batch_size = _shard_for_process(np.arange(len(ds)), test_cfg.get("batch_size", 256))
    return HostLoader(ds, idx, batch_size, shuffle=False)
