"""Profiler hooks: ``torch.profiler`` traces and a step-timing context (port
of ``ssrl_vit_mae_jepa_tpu/utils/profiling.py``, whose ``trace`` wraps
``jax.profiler``). A trace holds the host's and the card's activity and
opens in TensorBoard's profile plugin or Perfetto (``*.pt.trace.json``)."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str | Path | None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where there is a
    card) into ``log_dir`` (no-op when None)."""
    if log_dir is None:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield


class StepTimer:
    """Cheap rolling step timer (host wall clock; device-async aware callers
    should place it around a synchronize)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0
