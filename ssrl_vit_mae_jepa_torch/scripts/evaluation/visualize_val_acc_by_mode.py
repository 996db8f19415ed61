"""Validation-accuracy-by-finetune-mode plot (port of
``scripts/evaluation/visualize_val_acc_by_mode.py``): read the best score out
of each ablation run's ``best.ckpt`` (the port's checkpoints keep it under
``callbacks.best_model_score``, the reference's Lightning files in their
``callbacks`` dict), parse the ``mae_<pct>_<labels>_<mode>`` run names and
plot the mean best val accuracy per mode → ``val_accuracy_by_mode.png``."""

from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from pathlib import Path

NAME_RE = re.compile(r"mae_(\d{3})_(\d+)_(frozen|unfreeze1|unfreeze2|full)$")
MODE_ORDER = ["frozen", "unfreeze1", "unfreeze2", "full"]


def best_score_from_checkpoint(path: Path):
    import torch

    from ssrl_vit_mae_jepa_torch.utils.checkpoint import FORMAT_KEY

    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        return None
    callbacks = ckpt.get("callbacks", {})
    if ckpt.get("__format__") == FORMAT_KEY:
        return callbacks.get("best_model_score")
    for cb in callbacks.values():  # the reference's Lightning checkpoint
        if isinstance(cb, dict) and "best_model_score" in cb:
            score = cb["best_model_score"]
            return float(score) if score is not None else None
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot val accuracy by finetune mode")
    parser.add_argument("--outputs_dir", type=str, default="outputs/train")
    parser.add_argument("--output", type=str,
                        default="assets/visualizations/val_accuracy_by_mode.png")
    args = parser.parse_args(argv)

    by_mode = defaultdict(list)
    records = []
    for run_dir in sorted(Path(args.outputs_dir).iterdir()):
        m = NAME_RE.match(run_dir.name)
        best = run_dir / "checkpoints" / "best.ckpt"
        if not m or not best.exists():
            continue
        score = best_score_from_checkpoint(best)
        if score is None:
            continue
        frac, labels, mode = m.group(1), int(m.group(2)), m.group(3)
        by_mode[mode].append(score)
        records.append({"fraction": frac, "labels": labels, "mode": mode,
                        "best_val_acc": score})
        print(f"{run_dir.name}: best val_acc={score:.4f}")
    if not records:
        print(f"No completed runs found under {args.outputs_dir}")
        return records

    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.with_suffix(".json").write_text(json.dumps(records, indent=2))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np
    except ImportError:
        print("matplotlib unavailable: wrote JSON only")
        return records
    modes = [m for m in MODE_ORDER if m in by_mode]
    means = [float(np.mean(by_mode[m])) for m in modes]
    stds = [float(np.std(by_mode[m])) for m in modes]
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.bar(modes, means, yerr=stds, capsize=4, color="tab:blue", alpha=0.8)
    ax.set_ylabel("mean best val accuracy")
    ax.set_title("Validation accuracy by fine-tuning mode")
    ax.grid(axis="y", alpha=0.3)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"Saved plot to {out_path}")
    return records


if __name__ == "__main__":
    main()
