"""Classifier evaluation CLI on the STL-10 test split (port of
``scripts/evaluation/evaluate_classifier.py``).

``--config`` / ``--checkpoint``; without a checkpoint, the best checkpoint of
the training run the config describes (``default_checkpoint``, with the
fallback to ``train/mae_finetune``, ``:26-43``). Scoring is
``scripts/utils.py::evaluate_checkpoint``: top-1 and top-5 accuracy.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ssrl_vit_mae_jepa_torch.scripts.utils import (
    evaluate_checkpoint,
    setup_reproducibility,
    shut_down_warnings,
)


def default_checkpoint(cfg: dict) -> Path:
    """``<outputs>/train/<train.output_dir_suffix>/checkpoints/best.ckpt``
    where it exists, else the train CLI's default run ``mae_finetune``
    where that exists, else the first."""
    root = Path(cfg["logging"]["output_dir_base"])
    suffix = cfg["train"].get("output_dir_suffix", "default")
    contract = root / "train" / suffix / "checkpoints" / "best.ckpt"
    if contract.exists():
        return contract
    fallback = root / "train" / "mae_finetune" / "checkpoints" / "best.ckpt"
    return fallback if fallback.exists() else contract


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Score a trained ViT classifier on the STL-10 test set")
    parser.add_argument("--config", default="configs/mae.yaml")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint to evaluate (.ckpt or .pt); defaults to the "
                             "config's training run's best.ckpt")
    args = parser.parse_args(argv)
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.data.loaders import get_test_dataloader

    cfg = load_config(args.config)
    ckpt = args.checkpoint or str(default_checkpoint(cfg))
    if args.checkpoint is None:
        print(f"No --checkpoint given; evaluating {ckpt}")
    accuracy = evaluate_checkpoint(cfg, ckpt, get_test_dataloader(cfg))
    print(f"Evaluation complete — accuracy: {accuracy}")
    return accuracy


if __name__ == "__main__":
    main()
