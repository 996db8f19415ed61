"""Test-accuracy sweep plot across pretrain fractions × label budgets (port
of ``scripts/evaluation/visualize_test_accuracy.py``): scan
``assets/weights/mae_<pct>_<labels>.{pt,ckpt}``, evaluate each on the STL-10
test split and plot accuracy against labels/class, one curve per pretrain
fraction → ``test_accuracy_comparison_plot.png`` (and its ``.json``)."""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

from ssrl_vit_mae_jepa_torch.scripts.utils import (
    evaluate_checkpoint,
    setup_reproducibility,
    shut_down_warnings,
)

NAME_RE = re.compile(r"mae_(\d{3})_(\d+)\.(pt|ckpt)$")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot test accuracy across the sweep")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--weights_dir", type=str, default="assets/weights")
    parser.add_argument("--output", type=str,
                        default="assets/visualizations/test_accuracy_comparison_plot.png")
    args = parser.parse_args(argv)
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.data.loaders import get_test_dataloader

    cfg = load_config(args.config)
    test_loader = get_test_dataloader(cfg)
    results: dict[str, dict[int, float]] = {}
    for path in sorted(Path(args.weights_dir).iterdir()):
        m = NAME_RE.match(path.name)
        if not m:
            continue
        frac, labels = m.group(1), int(m.group(2))
        acc = evaluate_checkpoint(cfg, path, test_loader)
        results.setdefault(frac, {})[labels] = float(acc)
        print(f"{path.name}: test_acc={acc:.4f}")
    if not results:
        print(f"No mae_<pct>_<labels> weights found in {args.weights_dir}")
        return results

    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.with_suffix(".json").write_text(json.dumps(results, indent=2))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable: wrote JSON only")
        return results
    fig, ax = plt.subplots(figsize=(8, 6))
    for frac in sorted(results):
        pts = sorted(results[frac].items())
        label = "random init" if frac == "000" else f"{int(frac)}% pretrain data"
        ax.plot([x for x, _ in pts], [y for _, y in pts], marker="o", label=label)
    ax.set_xlabel("labeled samples per class")
    ax.set_ylabel("test top-1 accuracy")
    ax.set_xscale("log")
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title("STL-10 test accuracy vs label budget")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"Saved plot to {out_path}")
    return results


if __name__ == "__main__":
    main()
