"""Metrics logging: JSONL always, TensorBoard events when available.

The PyTorch port's own copy of ``ssrl_vit_mae_jepa_tpu/utils/metrics_logger.py``.

Mirrors the reference's observability surface (SURVEY.md §5.5): per-run
TensorBoard logs under ``<out>/logs/tb/`` plus scalar logging of losses,
accuracies, learning rate, and mask ratio. A ``metrics.jsonl`` file is always
written (grep/plot-friendly, no deps); TB event files are produced via
``torch.utils.tensorboard`` when torch+tensorboard are importable.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str | Path):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.output_dir / "metrics.jsonl"
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        tb_dir = self.output_dir / "logs" / "tb"
        try:  # optional dependency
            from torch.utils.tensorboard import SummaryWriter

            tb_dir.mkdir(parents=True, exist_ok=True)
            self._tb = SummaryWriter(log_dir=str(tb_dir))
        except Exception:
            self._tb = None

    def log(self, metrics: Dict[str, float], step: int, epoch: Optional[int] = None):
        rec = {"step": int(step), "time": time.time()}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), global_step=int(step))

    def flush(self):
        """Push buffered TB events to disk (SummaryWriter buffers ~2 min;
        a crash right after an epoch must not lose its scalars)."""
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
