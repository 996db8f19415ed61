"""MAE pretraining sweep over unlabeled-data fractions.

Port of ``scripts/ablation/run_pretrain_ablation.py``: the same grid, chain and
skip rules; its runs start the port's CLIs (``MODULE``).

Behavioral contract (SURVEY.md §3.4; reference behavior at
``scripts/ablation/run_pretrain_ablation.py`` — rewritten here from the
contract, not the text): sweep ``pretrain.data_fraction`` over
{25, 50, 75, 100}%, one ``pretrain_mae`` subprocess per
fraction writing to ``<outputs>/pretrain/mae_<NNN>/``; persist each derived
config as ``configs/mae_<NNN>.yaml``; skip fractions whose best checkpoint
already exists (resumable sweep); abort the remaining fractions on the first
failed run — downstream sweeps chain off these checkpoints, so continuing
past a failure would waste the whole grid.

Override the grid with ``SSRL_ABLATION_FRACTIONS`` (floats, e.g. "0.25,1.0")
and the base config with ``SSRL_ABLATION_CONFIG``.
"""

from __future__ import annotations

import argparse

from pathlib import Path

from ssrl_vit_mae_jepa_torch.scripts.ablation import common

MODULE = "ssrl_vit_mae_jepa_torch.scripts.training.pretrain_mae"


def fraction_suffix(fraction: float) -> str:
    """0.25 → 'mae_025', 1.0 → 'mae_100' (zero-padded percent)."""
    return f"mae_{int(round(fraction * 100)):03d}"


def sweep(fractions: list[float]) -> None:
    base = common.load_base_config()

    for fraction in fractions:
        suffix = fraction_suffix(fraction)
        cfg = common.derive_config(base, "pretrain", {"data_fraction": float(fraction)})
        cfg_path = common.write_config(cfg, Path("configs") / f"{suffix}.yaml")
        print(f"[pretrain-ablation] fraction={fraction:g} config={cfg_path}")

        if common.best_checkpoint(cfg, "pretrain", suffix).exists():
            print(f"[pretrain-ablation] {suffix} already has best.ckpt — skipping")
            continue

        code = common.launch(MODULE, cfg_path, suffix)
        if code != 0:
            print(f"[pretrain-ablation] {suffix} FAILED (exit {code}); "
                  "aborting remaining fractions")
            print("Pretraining sweep ABORTED — remaining fractions not run")
            return
        print(f"[pretrain-ablation] {suffix} done")

    print("All requested pretraining experiments completed")


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    sweep(common.grid_from_env("SSRL_ABLATION_FRACTIONS", "0.25,0.5,0.75,1.0", float))


if __name__ == "__main__":
    main()
