"""Downstream fine-tuning sweep: fraction × label budget × fine-tune mode.

Port of ``scripts/ablation/run_train_ablation.py``: the same grid, chain and
skip rules; its runs start the port's CLIs (``MODULE``).

Behavioral contract (SURVEY.md §3.4; reference behavior at
``scripts/ablation/run_train_ablation.py:24-40,73-91`` — rewritten here from
the contract, not the text):

  * grid = pretrain fraction {100, 75, 50, 25} × labels/class
    {400, 300, 200, 100, 50, 25, 10} × mode {frozen, unfreeze1, unfreeze2,
    full}, run in that nesting order;
  * the four modes CHAIN within a (fraction, labels) cell: ``frozen`` starts
    from the pretrain best via ``--encoder_ckpt``; each later mode starts from
    the previous mode's best classifier via ``--classifier_ckpt``;
  * per-mode hyperparameters: frozen → encoder frozen, lr 3e-4; unfreeze1 →
    last 1 block trainable, lr 1e-4; unfreeze2 → last 2 blocks, lr 5e-5;
    full → everything trainable, lr 5e-5 (``unfreeze_last_layers`` must be
    absent from the config for frozen/full);
  * output dirs are ``<outputs>/train/mae_<frac>_<labels>_<mode>`` — the
    naming scheme the harvest/viz tooling globs for;
  * a cell whose best.ckpt exists is skipped; a cell whose input checkpoint
    is missing, or whose subprocess fails, is reported and the sweep moves on
    (unlike the pretrain sweep, one broken cell only invalidates the rest of
    its own chain).

Grid overrides: ``SSRL_ABLATION_FRACTIONS`` (ints, e.g. "100"),
``SSRL_ABLATION_LABELS``; base config via ``SSRL_ABLATION_CONFIG``.
"""

from __future__ import annotations

import argparse

from dataclasses import dataclass
from pathlib import Path

from ssrl_vit_mae_jepa_torch.scripts.ablation import common

MODULE = "ssrl_vit_mae_jepa_torch.scripts.training.train_mae"


@dataclass(frozen=True)
class Mode:
    name: str
    learning_rate: float
    freeze_encoder: bool
    unfreeze_last_layers: int | None  # None → key absent from the config
    follows: str | None  # previous stage in the chain; None → pretrain ckpt


CHAIN: tuple[Mode, ...] = (
    Mode("frozen",    3e-4, True,  None, follows=None),
    Mode("unfreeze1", 1e-4, False, 1,    follows="frozen"),
    Mode("unfreeze2", 5e-5, False, 2,    follows="unfreeze1"),
    Mode("full",      5e-5, False, None, follows="unfreeze2"),
)


def run_name(frac_pct: int, labels: int, mode_name: str) -> str:
    return f"mae_{frac_pct:03d}_{labels}_{mode_name}"


def input_checkpoint(cfg: dict, frac_pct: int, labels: int, mode: Mode) -> Path:
    """The checkpoint this stage trains from (pretrain best or previous stage)."""
    if mode.follows is None:
        return common.best_checkpoint(cfg, "pretrain", f"mae_{frac_pct:03d}")
    return common.best_checkpoint(cfg, "train",
                                  run_name(frac_pct, labels, mode.follows))


def run_cell(base: dict, frac_pct: int, labels: int, mode: Mode) -> None:
    suffix = run_name(frac_pct, labels, mode.name)
    cfg = common.derive_config(base, "train", {
        "samples_per_class": labels,
        "learning_rate": mode.learning_rate,
        "freeze_encoder": mode.freeze_encoder,
        "unfreeze_last_layers": mode.unfreeze_last_layers,
    })

    if common.best_checkpoint(cfg, "train", suffix).exists():
        print(f"[train-ablation] {suffix} already done — skipping")
        return

    source = input_checkpoint(cfg, frac_pct, labels, mode)
    if not source.exists():
        print(f"[train-ablation] {suffix}: input checkpoint missing ({source}) "
              "— skipping this stage")
        return

    ckpt_flag = "--encoder_ckpt" if mode.follows is None else "--classifier_ckpt"
    cfg_path = common.write_config(cfg, Path("configs") / f"tmp_{suffix}.yaml")
    try:
        code = common.launch(MODULE, cfg_path, suffix,
                             (ckpt_flag, str(source)))
    finally:
        # failed cells must not leak tmp_*.yaml into the tracked configs/
        cfg_path.unlink(missing_ok=True)
    if code != 0:
        print(f"[train-ablation] {suffix} FAILED (exit {code}); continuing sweep")
        return
    print(f"[train-ablation] {suffix} done")


def sweep(fractions: list[int], label_budgets: list[int]) -> None:
    base = common.load_base_config()
    for frac_pct in fractions:
        for labels in label_budgets:
            print(f"[train-ablation] cell: fraction={frac_pct}% labels={labels}")
            for mode in CHAIN:
                run_cell(base, frac_pct, labels, mode)
    print("ALL DOWNSTREAM ABLATIONS COMPLETED")


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    sweep(
        common.grid_from_env("SSRL_ABLATION_FRACTIONS", "100,75,50,25", int),
        common.grid_from_env("SSRL_ABLATION_LABELS", "400,300,200,100,50,25,10", int),
    )


if __name__ == "__main__":
    main()
