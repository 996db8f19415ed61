"""Harvest best checkpoints from the ablation sweep into assets/weights/
(port of ``scripts/weight_utils/copy_ckpts.py``, format-agnostic file copies).

Reference contract (``scripts/weight_utils/copy_ckpts.py:34-56``): copy each
``outputs/train/mae_<pct>_<labels>_full/checkpoints/best.ckpt`` to
``assets/weights/mae_<pct>_<labels>.ckpt``.
"""

from __future__ import annotations

import argparse
import re
import shutil
from pathlib import Path

NAME_RE = re.compile(r"^mae_(\d{3})_(\d+)_(\w+)$")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Harvest ablation best checkpoints")
    parser.add_argument("--outputs_dir", type=str, default="outputs/train")
    parser.add_argument("--dest_dir", type=str, default="assets/weights")
    parser.add_argument("--mode", type=str, default="full")
    args = parser.parse_args(argv)

    dest = Path(args.dest_dir)
    dest.mkdir(parents=True, exist_ok=True)
    copied = 0
    # also harvest the random-init baseline runs (mae_000_<k>, no mode suffix)
    for run_dir in sorted(Path(args.outputs_dir).iterdir()):
        m = NAME_RE.match(run_dir.name)
        baseline = re.match(r"^mae_000_(\d+)$", run_dir.name)
        if m and m.group(3) == args.mode:
            frac, labels = m.group(1), m.group(2)
        elif baseline:
            frac, labels = "000", baseline.group(1)
        else:
            continue
        src = run_dir / "checkpoints" / "best.ckpt"
        if not src.exists():
            continue
        dst = dest / f"mae_{frac}_{labels}.ckpt"
        shutil.copy2(src, dst)
        copied += 1
        print(f"{src} → {dst}")
    print(f"Copied {copied} checkpoints to {dest}")
    return copied


if __name__ == "__main__":
    main()
