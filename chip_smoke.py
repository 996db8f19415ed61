#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: kernels, then the MAE pretraining step.

Run from the repository root on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``ssrl_vit_mae_jepa_torch/csrc``;
  3. at the main path's shapes (B=768; encoder L=37, D=144; decoder L=145,
     D=192; H=6, F=4D; bf16) each branch kernel, forward and all seven
     backward outputs, against its plain PyTorch version on the card, with
     the kernel's and the plain version's times;
  4. the flagship MAE step through ``MAETask`` (configs/mae.yaml geometry,
     bench.py's pretraining settings, B=768, bf16, augmentation on): warm-up,
     then timed steps; every loss finite, the params moved, and exactly one
     launch of each branch kernel per block per step;
  5. the same step at B=16 from the same weights and draws on the card and
     through the plain path on the CPU: the losses agree.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import yaml

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask

REPO = pathlib.Path(__file__).resolve().parent
BATCH = 768
STEPS, WARMUP = 10, 3
# bench.py:81-86, the pretraining settings the JAX bench times
PRE_CFG = {
    "mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
    "total_epochs": 800, "warmup_epochs": 20, "batch_size": BATCH,
    "base_learning_rate": 1.5e-4, "weight_decay": 0.05, "augment": True,
}
# (name, geometry) -> blocks per step that call it: 4 encoder, 2 decoder
GEOMETRIES = {"enc": (37, 144, 6, 4), "dec": (145, 192, 6, 2)}  # L, D, H, depth
KERNELS = {
    "attn_branch_fwd": ("attn_branch.cu", "ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:722"),
    "attn_branch_bwd": ("attn_branch.cu", "ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:752"),
    "mlp_branch_fwd": ("mlp_branch.cu", "ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:807"),
    "mlp_branch_bwd": ("mlp_branch.cu", "ssrl_vit_mae_jepa_tpu/ops/block_pallas.py:831"),
}
FWD_ATOL = 6e-2       # bf16 forward tolerance of tests/test_block_kernel.py
# backward: both sides round to bf16 at different points (the plain version's
# autograd rounds dW, dP and dy1 to bf16; the kernel keeps them in f32), so
# each output is held to 2% of its largest magnitude -- far below the O(1)
# relative error of a layout or indexing fault
BWD_REL = 2e-2
LOSS_RTOL = 2e-2      # bf16 step, kernels on the card vs plain on the CPU


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def branch_inputs(kind: str, L: int, D: int, seed: int):
    """bf16 activations and f32 params at realistic scales, on the card."""
    g = torch.Generator().manual_seed(seed)
    n = 3 * D if kind == "attn" else 4 * D
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    wb_in = D if kind == "attn" else n
    params = [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(n, D) * D**-0.5, 0.1 * rn(n),
              rn(D, wb_in) * wb_in**-0.5, 0.1 * rn(D)]
    x = rn(BATCH, L, D).to(torch.bfloat16)
    dy = rn(BATCH, L, D).to(torch.bfloat16)
    return x.cuda(), dy.cuda(), [p.cuda() for p in params]


def check_kernels() -> dict:
    """Phase 3: per kernel, max abs error and per-step ms vs plain."""
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in KERNELS}
    for geo, (L, D, H, depth) in GEOMETRIES.items():
        for kind in ("attn", "mlp"):
            x, dy, params = branch_inputs(kind, L, D, seed=L + D)
            extra = (H,) if kind == "attn" else ()
            kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
            ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref
            leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
            out_k = kern(*leaves, *extra)
            grads_k = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
            out_r = ref(*leaves, *extra)
            grads_r = torch.autograd.grad(out_r, leaves, dy, retain_graph=True)
            with torch.no_grad():
                out_ns = kern(x, *params, *extra)
            torch.cuda.synchronize()
            if not torch.equal(out_ns, out_k):
                fail(f"{kind}@{geo}: the no-stash forward differs from the stash forward")
            fwd_err = (out_k.float() - out_r.float()).abs().max().item()
            if not fwd_err <= FWD_ATOL:
                fail(f"{kind}@{geo} forward: max abs err {fwd_err} > {FWD_ATOL}")
            bwd_err = 0.0
            names = ["dx", "d_ln_scale", "d_ln_bias", "d_w_a", "d_b_a", "d_w_b", "d_b_b"]
            for name, a, b in zip(names, grads_k, grads_r):
                err = (a.float() - b.float()).abs().max().item()
                bound = BWD_REL * b.float().abs().max().item() + 1e-3
                print(f"  {kind}@{geo} {name}: max abs err {err:.3e} (bound {bound:.3e})")
                if not err <= bound:
                    fail(f"{kind}@{geo} backward {name}: max abs err {err} > {bound}")
                bwd_err = max(bwd_err, err)
            times = {
                "fwd": cuda_ms(lambda: kern(*leaves, *extra)),
                "plain_fwd": cuda_ms(lambda: ref(*leaves, *extra)),
                "bwd": cuda_ms(lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True)),
                "plain_bwd": cuda_ms(lambda: torch.autograd.grad(out_r, leaves, dy, retain_graph=True)),
            }
            print(f"  {kind}@{geo} L={L} D={D}: fwd {times['fwd']:.3f} ms "
                  f"(plain {times['plain_fwd']:.3f}), bwd {times['bwd']:.3f} ms "
                  f"(plain {times['plain_bwd']:.3f}); fwd max abs err {fwd_err:.3e}",
                  flush=True)
            for pas, err in (("fwd", fwd_err), ("bwd", bwd_err)):
                r = res[f"{kind}_branch_{pas}"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ms"] += depth * times[pas]
                r["plain_ms"] += depth * times[f"plain_{pas}"]
                r[f"ms_{geo}"] = times[pas]
                r[f"plain_ms_{geo}"] = times[f"plain_{pas}"]
            del out_k, out_r, grads_k, grads_r, leaves
    return res


def mae_step(model_cfg: dict, name: str) -> dict:
    """Phase 4: the flagship step through MAETask on the card."""
    task = MAETask(model_cfg, PRE_CFG, dtype=torch.bfloat16, device="cuda")
    state = task.init_state(0)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    images = np.random.default_rng(0).integers(0, 256, (BATCH, 96, 96, 3)).astype(np.uint8)
    batch = {"image": torch.from_numpy(images).cuda(),
             "weight": torch.ones(BATCH, device="cuda")}
    ctx = task.epoch_context(0)
    losses = []
    for _ in range(WARMUP):
        state, sums = task.train_step(state, batch, 0, ctx)
        losses.append(sums["loss_sum"])
    torch.cuda.synchronize()
    bf.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        state, sums = task.train_step(state, batch, 0, ctx)
        losses.append(sums["loss_sum"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(bf.LAUNCHES)
    ms = start.elapsed_time(end) / STEPS
    losses = [float(v) / BATCH for v in losses]
    print(f"  MAE step B={BATCH} bf16 on {name}: {ms:.3f} ms/step (CUDA events), "
          f"{BATCH / ms * 1e3:.1f} img/s; wall {wall / STEPS * 1e3:.3f} ms/step; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  losses: {[round(v, 5) for v in losses]}")
    print(f"  launches over {STEPS} steps: {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    moved = sum(int(not torch.equal(before[k], v)) for k, v in state.params.items())
    if moved != len(before):
        fail(f"only {moved} of {len(before)} parameters changed")
    blocks = sum(depth for *_, depth in GEOMETRIES.values())
    for k in KERNELS:
        if launches[k] != blocks * STEPS:
            fail(f"{k}: {launches[k]} launches in {STEPS} steps, expected {blocks * STEPS}")
    return {k: launches[k] for k in KERNELS}


def cpu_agreement(model_cfg: dict) -> None:
    """Phase 5: B=16, same weights and draws, kernels vs plain CPU path."""
    n = 16
    gpu = MAETask(model_cfg, PRE_CFG, dtype=torch.bfloat16, device="cuda")
    cpu = MAETask(model_cfg, PRE_CFG, dtype=torch.bfloat16, device="cpu")
    gs, cs = gpu.init_state(1), cpu.init_state(1)
    cpu.model.load_state_dict(gpu.model.state_dict())
    images = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)
    )
    ctx = gpu.epoch_context(0)
    draws = gpu.draw(gs.generator, n, ctx)
    weight = torch.ones(n)
    before = {k: v.detach().cpu().clone() for k, v in cs.params.items()}
    bf.reset_launch_counts()
    _, s_gpu = gpu.train_step(gs, {"image": images.cuda(), "weight": weight.cuda()},
                              0, ctx, draws)
    launched = sum(bf.LAUNCHES.values())
    _, s_cpu = cpu.train_step(cs, {"image": images, "weight": weight}, 0, ctx,
                              tuple(d.cpu() for d in draws))
    if sum(bf.LAUNCHES.values()) != launched or launched != 24:
        fail(f"launch counts: {dict(bf.LAUNCHES)} (GPU step must launch 24, CPU none)")
    lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
    print(f"  B={n} loss: kernels on the card {lg:.6f}, plain on the CPU {lc:.6f}")
    if not abs(lg - lc) <= LOSS_RTOL * abs(lc):
        fail(f"loss disagrees: {lg} vs {lc} (rtol {LOSS_RTOL})")
    lr = s_cpu["lr"]
    worst = max((gs.params[k].detach().cpu() - cs.params[k].detach()).abs().max().item()
                for k in cs.params)
    step = max((cs.params[k].detach() - before[k]).abs().max().item() for k in cs.params)
    print(f"  after one step: max |param gpu - cpu| {worst:.3e}, lr {lr:.3e}, "
          f"largest update {step:.3e}")
    # Adam's first step is about +-lr per element, whatever the gradient's size
    if not worst <= 2.5 * lr:
        fail(f"updated params disagree by {worst} > 2.5 lr")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: {card()}", flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"phase 2: built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 3: kernels vs plain versions (B=768, bf16)", flush=True)
    res = check_kernels()

    model_cfg = yaml.safe_load((REPO / "configs" / "mae.yaml").read_text())["model"]
    print("phase 4: MAE pretraining step", flush=True)
    launches = mae_step(model_cfg, name)

    print("phase 5: B=16 step, kernels vs plain CPU path", flush=True)
    cpu_agreement(model_cfg)

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        r = res[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"ssrl_vit_mae_jepa_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            # per training step: 4 encoder calls + 2 decoder calls
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            **{kk: v for kk, v in r.items() if kk.startswith(("ms_", "plain_ms_"))},
        })
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
