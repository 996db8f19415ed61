#!/usr/bin/env python3
"""Where the device time of the port's MAE and JEPA steps goes, on one
NVIDIA GPU.

Runs the flagship pretraining step of the PyTorch port (the geometry of
``configs/mae.yaml`` and the settings of ``chip_smoke.py``: B=768, bf16,
augmentation on) for each ``--task`` and each ``--attn-impl``: 3 warm-up
steps, then 5 steps timed with CUDA events,
then 5 steps under ``torch.profiler``. Prints, per run, the step time, the
device time summed over all kernels, the device's idle share of the step,
the branch GEMM's kernels summed (ms and calls per step) and the kernels by
device time per step; ``--out`` also writes them as
JSON. ``SSRL_FUSED_EMBED=1`` in the environment switches the fused patch
embed on. Needs a GPU::

    python3 tools/torch_step_profile.py --task mae jepa --attn-impl auto block chain --out prof.json

It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import PRE_CFG, card, device_us  # noqa: E402
from ssrl_vit_mae_jepa_torch.config import load_config  # noqa: E402
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask  # noqa: E402
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask  # noqa: E402

STEPS, WARMUP, TOP = 5, 3, 40  # timed and profiled steps, warm-up, kernels listed
# the branch kernels' GEMM (csrc/gemm_sm90.cuh): every instantiation's name has it
GEMM_KERNEL = "gemm_sm90_kernel"


def make_task(name: str, impl: str):
    cfg = load_config(REPO / "configs" / "mae.yaml")
    if name == "jepa":
        jepa_cfg = {**cfg["jepa"], "batch_size": PRE_CFG["batch_size"]}
        return JEPATask(cfg["model"], jepa_cfg, dtype=torch.bfloat16, device="cuda",
                        attn_impl=impl)
    return MAETask(cfg["model"], PRE_CFG, dtype=torch.bfloat16, device="cuda", attn_impl=impl)


def profile(name: str, impl: str) -> dict:
    batch, steps = PRE_CFG["batch_size"], STEPS
    task = make_task(name, impl)
    state = task.init_state(0)
    images = np.random.default_rng(0).integers(0, 256, (batch, 96, 96, 3)).astype(np.uint8)
    data = {"image": torch.from_numpy(images).cuda(),
            "weight": torch.ones(batch, device="cuda")}
    ctx = task.epoch_context(0)

    def run(n):
        nonlocal state
        for _ in range(n):
            state, _ = task.train_step(state, data, 0, ctx)

    run(WARMUP)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(steps)
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (us / 1e3 / steps, evt.count / steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    gemm = [v for k, v in kernels.items() if GEMM_KERNEL in k]
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "task": name, "attn_impl": impl, "batch": batch, "steps": steps,
        "step_ms": step_ms, "img_per_s": batch / step_ms * 1e3,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / step_ms,
        "gemm_ms_per_step": sum(ms for ms, _ in gemm),
        "gemm_calls_per_step": sum(n for _, n in gemm),
        "kernels": [{"name": k, "ms_per_step": ms, "calls_per_step": n}
                    for k, (ms, n) in ranked[:TOP]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", nargs="+", default=["mae"], choices=["mae", "jepa"])
    ap.add_argument("--attn-impl", nargs="+", default=["auto", "packed", "pallas"])
    ap.add_argument("--out", type=pathlib.Path, help="also write the results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profile needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card(), "kind": torch.cuda.get_device_name(0), "runs": []}
    print(out["card"])
    runs = [(t, i) for t in args.task for i in args.attn_impl]
    for name, impl in runs:
        r = profile(name, impl)
        out["runs"].append(r)
        print(f"{name} attn_impl={impl} B={r['batch']}: {r['step_ms']:.3f} ms/step (CUDA events), "
              f"{r['img_per_s']:.1f} img/s; kernels {r['device_ms_per_step']:.3f} ms/step "
              f"on the device, idle {100 * r['idle_share']:.1f}%")
        print(f"  {r['gemm_ms_per_step']:8.3f} ms/step  {r['gemm_calls_per_step']:6.1f} calls  "
              f"branch GEMM ({GEMM_KERNEL}, all instantiations)")
        for k in r["kernels"]:
            print(f"  {k['ms_per_step']:8.3f} ms/step  {k['calls_per_step']:6.1f} calls  "
                  f"{k['name'][:110]}")
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
