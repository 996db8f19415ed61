"""Supervised-from-scratch baseline sweep over label budgets.

Port of ``scripts/ablation/run_baseline_ablation.py``: the same grid, chain and
skip rules; its runs start the port's CLIs (``MODULE``).

Behavioral contract (SURVEY.md §3.4; reference behavior at
``scripts/ablation/run_baseline_ablation.py`` — rewritten here from the
contract, not the text): for each labels-per-class budget, train a
random-init ViT classifier — ``train_mae`` with NO
checkpoint flags, full fine-tune (encoder unfrozen, no
``unfreeze_last_layers``) — writing to ``<outputs>/train/mae_000_<k>`` so the
"0% pretraining" row slots into the same harvest/viz naming scheme as the
MAE runs. Each run's derived config is persisted inside its own output dir;
completed runs (best.ckpt present) are skipped.

Grid override: ``SSRL_ABLATION_LABELS``; base config via
``SSRL_ABLATION_CONFIG``.
"""

from __future__ import annotations

import argparse

from ssrl_vit_mae_jepa_torch.scripts.ablation import common

MODULE = "ssrl_vit_mae_jepa_torch.scripts.training.train_mae"


def sweep(label_budgets: list[int]) -> None:
    base = common.load_base_config()

    for labels in label_budgets:
        suffix = f"mae_000_{labels}"
        cfg = common.derive_config(base, "train", {
            "samples_per_class": labels,
            "freeze_encoder": False,
            "unfreeze_last_layers": None,
        })
        run_dir = common.outputs_root(cfg) / "train" / suffix
        cfg_path = common.write_config(cfg, run_dir / "config.yaml")
        print(f"[baseline-ablation] labels/class={labels} config={cfg_path}")

        if common.best_checkpoint(cfg, "train", suffix).exists():
            print(f"[baseline-ablation] {suffix} already done — skipping")
            continue

        code = common.launch(MODULE, cfg_path, suffix)
        if code != 0:
            raise SystemExit(
                f"[baseline-ablation] {suffix} FAILED (exit {code})")
        print(f"[baseline-ablation] {suffix} done")

    print("Baseline ablation complete")


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    sweep(common.grid_from_env("SSRL_ABLATION_LABELS",
                               "10,25,50,100,200,300,400", int))


if __name__ == "__main__":
    main()
