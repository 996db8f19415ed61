"""Profiler hooks: ``torch.profiler`` traces and a step-timing context (port
of ``ssrl_vit_mae_jepa_tpu/utils/profiling.py``, whose ``trace`` wraps
``jax.profiler``). A trace holds the host's and the card's activity and
opens in TensorBoard's profile plugin or Perfetto (``*.pt.trace.json``).

From a finished profile, ``device_step_ms`` is the device time per step
(the counterpart of ``utils/flops.py::device_step_ms_from_trace``) and
``op_table`` the device time per step by kernel name (of
``tools/trace_ops.py``); both count the CUDA kernels the profiler recorded,
those a CUDA graph's replay launches among them."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple


@contextlib.contextmanager
def trace(log_dir: str | Path | None) -> Iterator[Optional["torch.profiler.profile"]]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where there is a
    card) into ``log_dir`` and yield the profiler (no-op yielding None when
    ``log_dir`` is None). The caller synchronizes the card before the block
    ends, or the last kernels are missing."""
    if log_dir is None:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def device_us(evt) -> float:
    """Self device time of a profiler event in µs (the field's name changed
    across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def kernel_times(prof) -> Dict[str, Tuple[float, int]]:
    """kernel name → (device ms, launches) over a finished profile: the
    events that ran on a CUDA device."""
    import torch

    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = device_us(evt)
            if us > 0:
                out[evt.key] = (us / 1e3, int(evt.count))
    return out


def device_step_ms(prof, n_steps: int) -> Optional[float]:
    """The CUDA kernels' summed durations over ``n_steps``, per step; None
    when the profile holds no device time (a CPU run)."""
    total = sum(ms for ms, _ in kernel_times(prof).values())
    return total / n_steps if total > 0 else None


def op_table(prof, n_steps: int, top_k: int = 30) -> List[dict]:
    """The ``top_k`` kernels by device time, largest first: name, device ms
    and launches per step."""
    rows = sorted(kernel_times(prof).items(), key=lambda kv: -kv[1][0])[:top_k]
    return [{"name": k, "ms_per_step": ms / n_steps, "calls_per_step": n / n_steps}
            for k, (ms, n) in rows]


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
