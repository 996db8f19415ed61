#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: kernels, then the MAE and JEPA
pretraining steps.

Run from the repository root on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``ssrl_vit_mae_jepa_torch/csrc``;
  3. at the main paths' shapes (B=768, H=6, F=4D, bf16: the MAE encoder
     L=37, D=144 and decoder L=145, D=192; the JEPA context encoder L=45,
     D=144, predictor L=145, D=96 and target encoder L=145, D=144, the
     last under no-grad) each branch kernel, forward and all seven backward
     outputs, against its plain PyTorch version on the card, with the
     kernel's and the plain version's times; then every GEMM of those
     kernels alone (``bf.gemm``, the wgmma + TMA kernel of
     ``csrc/gemm_sm90.cuh``) at the same shapes against ``gemm_ref``, with
     its device time beside ``torch.matmul``'s (a yardstick, never a route)
     and its bound (a ``{"gemm_table": [...]}`` line);
  3b. the four attention entries of ``csrc/mha.cu``, forward and backward,
     at the encoder and decoder shapes (``mha_stacked`` also at the JEPA
     predictor's), against their plain versions on the card, with the
     kernel's, the plain version's and ``F.scaled_dot_product_attention``'s
     times (the yardstick, never a route of the port), the kernel's and
     the yardstick's also as device time under ``torch.profiler``; and the
     blocks per SM of both passes at (L, d) = (145, 32) and (37, 24);
  3c. the fused patch embed of ``csrc/patch_embed.cu``, forward and all
     backward outputs, at N=144, Pc=192, D=144 with K=37 (MAE), K=45 (JEPA
     context) and no index (JEPA target), against its plain version, with
     the kernel's, the plain version's and a gather + ``torch.matmul``'s
     times (the yardstick), and the kernel's and the yardstick's device
     times;
  4. the flagship MAE step through ``MAETask`` (configs/mae.yaml geometry,
     bench.py's pretraining settings, B=768, bf16, augmentation on): warm-up,
     then timed steps; every loss finite, the params moved, and exactly one
     launch of each branch kernel per block per step;
  5. the same step at B=16 from the same weights and draws on the card and
     through the plain path on the CPU: the losses agree;
  6, 7. phases 4 and 5 again with ``attn_impl="packed"`` and
     ``attn_impl="pallas"``: the blocks take the sub-layer route, and each
     step launches one forward and one backward attention kernel of that
     impl's entry per block (``mha_stacked_qkv``, ``mha_pallas``) and no
     branch kernel;
  8. the flagship JEPA step through ``JEPATask`` (configs/mae.yaml's model
     and jepa sections at B=768, bf16, augmentation on, attn_impl auto):
     every loss and collapse metric finite, every parameter moved, the EMA
     target moved, and per step exactly the branch launches of the context
     encoder (4 blocks), the predictor (2) and the no-grad target encoder
     (4), and no attention-entry or embed kernel;
  9. phase 8 with ``SSRL_FUSED_EMBED=1`` (two embed forwards and one
     backward more per step), then phase 4 with it (one and one more);
  3d. the whole-block kernel of ``csrc/fused_block.cu`` at the five block
     geometries of phase 3, forward and all 13 backward outputs (the target
     encoder's through the no-grad forward), against ``block_ref``, with
     the kernel's and the plain version's times;
  3e. the chained-block kernel of ``csrc/block_chain.cu`` at the five
     stacks (MAE encoder N=4 and decoder N=2, JEPA context encoder N=4 and
     predictor N=2 with the stash forward and the backward; the JEPA target
     encoder N=4 through the no-grad forward) against ``chain_ref``, with
     times; the stash forward's output equals the no-grad forward's and the
     split kernels' bit for bit;
  10. the JEPA step at B=16 on the card and through the plain path on the
     CPU from the same weights and draws: the losses agree;
  11, 12. phases 4 and 5 with ``attn_impl="block"`` and ``"chain"``: each
     step launches one whole-block forward and backward per block (6 + 6),
     or one chain forward and backward per stack (2 + 2), and no branch or
     attention kernel;
  13, 14. phases 8 and 10 with ``attn_impl="block"`` and ``"chain"``: per
     step the context encoder's and predictor's whole-block forwards and
     backwards (6 + 6) and the target encoder's 4 no-grad forwards, or
     their chain forwards and backwards (2 + 2) and the target's one
     no-grad chain forward; the EMA target moved.

Each main-path run (phases 4, 6-9, 11-14) zeroes every launch count just
before it and reads them just after. ``mha_stacked`` and ``mha_packed`` lie
on none of these paths (the JAX package reaches them from the JEPA
predictor's sub-layer route and by direct calls); phase 3b drives them.

The line before the last is ``{"kernels": [...]}`` (21 entries): per
kernel, ``ms``, ``plain_ms`` and ``bound_ms`` are per training step of
``step`` (the MAE step where it runs the kernel, else the JEPA step),
``*_jepa`` the same per JEPA step, ``*_<geometry>`` per call. ``ms`` and
the other times are CUDA-event means of the wrapper's call, host work
included; ``device_ms`` and ``library_device_ms`` (attention and embed
rows) are the summed durations of the device kernels one call launches.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

import torch.nn.functional as F

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.config import load_config
from ssrl_vit_mae_jepa_torch.ops import attention_core as core
from ssrl_vit_mae_jepa_torch.ops import block_chain as bc
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.ops import embed_fused as ef
from ssrl_vit_mae_jepa_torch.ops.attention_core import heads_of
from ssrl_vit_mae_jepa_torch.ops.attention_heads import mha_pallas, mha_pallas_ref
from ssrl_vit_mae_jepa_torch.ops.attention_packed import mha_packed, mha_packed_ref
from ssrl_vit_mae_jepa_torch.ops.attention_stacked import (
    mha_stacked,
    mha_stacked_qkv,
    mha_stacked_qkv_ref,
    mha_stacked_ref,
)
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
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
# name -> (L, D, H) of the transformer blocks
GEOMETRIES = {"enc": (37, 144, 6), "dec": (145, 192, 6), "ctx": (45, 144, 6),
              "pred": (145, 96, 6), "tgt": (145, 144, 6)}
# blocks per training step at each geometry, by main path; the JEPA target
# encoder ("tgt") runs under no-grad, so only forward kernels
STEP_CALLS = {"mae": {"enc": 4, "dec": 2}, "jepa": {"ctx": 4, "pred": 2, "tgt": 4}}
_TPU = "ssrl_vit_mae_jepa_tpu/ops/"
# branch kernel -> (source, TPU kernel, geometries it runs at)
_GRAD_GEOS = ("enc", "dec", "ctx", "pred")
KERNELS = {
    "attn_branch_fwd": ("attn_branch.cu", _TPU + "block_pallas.py:722", _GRAD_GEOS),
    "attn_branch_fwd_nograd": ("attn_branch.cu", _TPU + "block_pallas.py:692", ("tgt",)),
    "attn_branch_bwd": ("attn_branch.cu", _TPU + "block_pallas.py:752", _GRAD_GEOS),
    "mlp_branch_fwd": ("mlp_branch.cu", _TPU + "block_pallas.py:807", _GRAD_GEOS + ("tgt",)),
    "mlp_branch_bwd": ("mlp_branch.cu", _TPU + "block_pallas.py:831", _GRAD_GEOS),
}
# entry -> (kernel wrapper, plain version, TPU kernel fwd, TPU kernel bwd,
# geometries it is checked at)
ATTENTION = {
    "mha_stacked_qkv": (mha_stacked_qkv, mha_stacked_qkv_ref,
                        _TPU + "attention_pallas_stacked.py:440",
                        _TPU + "attention_pallas_stacked.py:461", ("enc", "dec")),
    "mha_stacked": (mha_stacked, mha_stacked_ref, _TPU + "attention_pallas_stacked.py:380",
                    _TPU + "attention_pallas_stacked.py:401", ("enc", "dec", "pred")),
    "mha_pallas": (mha_pallas, mha_pallas_ref, _TPU + "attention_pallas.py:144",
                   _TPU + "attention_pallas.py:166", ("enc", "dec")),
    "mha_packed": (mha_packed, mha_packed_ref, _TPU + "attention_pallas_packed.py:161",
                   _TPU + "attention_pallas_packed.py:186", ("enc", "dec")),
}
# the fused patch embed: N patches of Pc values into D; name -> K kept tokens
# (None: the full sequence, no gather), and its calls per step by main path
# (the MAE step runs it only with SSRL_FUSED_EMBED=1)
EMBED_N, EMBED_PC, EMBED_D = 144, 192, 144
EMBED_GEOS = {"k37": 37, "k45": 45, "full": None}
EMBED_CALLS = {"fwd": {"mae": {"k37": 1}, "jepa": {"k45": 1, "full": 1}},
               "bwd": {"mae": {"k37": 1}, "jepa": {"k45": 1}}}
EMBED_KERNELS = {"patch_embed_fwd": _TPU + "embed_pallas.py:185",
                 "patch_embed_bwd": _TPU + "embed_pallas.py:242"}
# phase 3b's CUDA-event means: more warm-up than phase 3, since the first
# backward timed after phase 3 ran up to 2x slow in one run
ATT_TIMING = {"iters": 30, "warmup": 10}
# the whole block (per block, the calls of STEP_CALLS) and the chain (per
# stack): kernel -> TPU kernel it replaces, and the chain's depth and calls
# per step at each geometry
BLOCK_KERNELS = {"block_fwd": _TPU + "block_pallas.py:408",
                 "block_fwd_nograd": _TPU + "block_pallas.py:408",
                 "block_bwd": _TPU + "block_pallas.py:442"}
CHAIN_KERNELS = {"chain_fwd": _TPU + "block_chain.py:261",
                 "chain_fwd_nograd": _TPU + "block_chain.py:235",
                 "chain_bwd": _TPU + "block_chain.py:288"}
CHAIN_DEPTH = {"enc": 4, "dec": 2, "ctx": 4, "pred": 2, "tgt": 4}
CHAIN_CALLS = {"mae": {"enc": 1, "dec": 1}, "jepa": {"ctx": 1, "pred": 1, "tgt": 1}}
# the attention entry each forced impl's main path must launch
IMPL_ENTRY = {"packed": "mha_stacked_qkv", "pallas": "mha_pallas"}
# the card's peaks (NVIDIA's H100 SXM data sheet): dense bf16 tensor-core
# rate and device-memory rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
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


def device_us(evt) -> float:
    """Self device time of a profiler event in µs (the name of the field
    changed across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event without a device time")


def device_ms(fn, iters: int = 10, by_kernel: dict | None = None) -> float:
    """Device time of one call of ``fn``: the summed durations of the device
    kernels it launches, under ``torch.profiler``, over ``iters`` calls after
    a warm-up call; ``by_kernel`` gets each kernel's share."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device activity
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        shares = {e.key: device_us(e) / 1e3 / iters for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
        if sum(shares.values()) > 0:
            break
        print("  (torch.profiler recorded no device time; profiling again)", flush=True)
    else:
        fail("torch.profiler saw no device time in three sessions")
    if by_kernel is not None:
        by_kernel.update(shares)
    return sum(shares.values())


def kernel_shares(shares: dict) -> str:
    """'name ms, ...' of a device_ms breakdown, short names, largest first."""
    def short(name: str) -> str:
        return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0][:40]

    return ", ".join(f"{short(k)} {v:.4f}"
                     for k, v in sorted(shares.items(), key=lambda kv: -kv[1]))


def bound(nbytes: float, flops: float):
    """(ms, what bounds it): the least time for the work at the card's peaks."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def branch_bounds(kind: str, L: int, D: int, stash: bool = True):
    """Per-call (fwd, bwd) bounds of a branch kernel at (B, L, D): bf16
    activations read and written once (the stash forward also writes the
    attention output ``a``), weights once (bf16 in, f32 grads out), and the
    GEMM operations the function needs (the backward recomputes the first
    GEMM from x, as it must: only x is an input)."""
    M = BATCH * L
    act = M * D * 2
    if kind == "attn":  # qkv 6MD^2 + attention 4BL^2D + proj 2MD^2
        w = 4 * D * D
        fwd = bound((3 if stash else 2) * act + 2 * w, 8 * M * D * D + 4 * BATCH * L * L * D)
        # recompute qkv 6, dWp 2, da 2, dWqkv 6, dy1 6 (x MD^2); attention 10BL^2D
        bwd = bound(4 * act + 2 * w + 4 * w, 22 * M * D * D + 10 * BATCH * L * L * D)
    else:  # fc1 and fc2, 8MD^2 each
        w = 8 * D * D
        fwd = bound(2 * act + 2 * w, 16 * M * D * D)
        # recompute fc1, dh, dW2, dW1, dy2 (8MD^2 each)
        bwd = bound(3 * act + 2 * w + 4 * w, 40 * M * D * D)
    return fwd, bwd


def attention_bounds(L: int, D: int):
    """Per-call (fwd, bwd) bounds of attention at (B, L, D): q, k, v (and dO)
    read once, o (or dq, dk, dv) written once; QK^T and PV forward, and the
    recomputed QK^T, dV, dP, dQ, dK backward, at 2BL^2D operations each."""
    act, mm = BATCH * L * D * 2, 2 * BATCH * L * L * D
    return bound(4 * act, 2 * mm), bound(7 * act, 5 * mm)


def stack_bounds(L: int, D: int, N: int, stash: bool):
    """Per-call (fwd, bwd) bounds of N blocks at (B, L, D), F = 4D. Bytes:
    x and the output (dy and dx) once, the chain's 3N - 1 stash tensors
    written by its forward and read by its backward, bf16 weights and f32
    LN params read once, f32 gradients written once. Operations per block:
    forward qkv 6, proj 2, fc1 8, fc2 8 (x MD^2) and attention 4BL^2D.
    Backward of the whole block (only x is an input): the forward up to
    x_mid again (8MD^2, 4BL^2D), the MLP's 40MD^2 (fc1 again, dh, dW2, dW1,
    dy2), dWp, da, dWqkv, dy1 16MD^2, the attention backward 8BL^2D; of a
    chain block (a and x_mid stashed): qkv again 6, the MLP's 40, 16, and
    the attention backward with QK^T again 10BL^2D."""
    M = BATCH * L
    act = M * D * 2
    w = N * ((12 * D * D + 9 * D) * 2 + 4 * D * 4)
    grads = N * (12 * D * D + 13 * D) * 4
    att = BATCH * L * L * D
    st = (3 * N - 1) * act if stash else 0
    fwd = bound(2 * act + st + w, N * (24 * M * D * D + 4 * att))
    if stash:
        bwd = bound(3 * act + st + w + grads, N * (62 * M * D * D + 10 * att))
    else:
        bwd = bound(3 * act + w + grads, N * (64 * M * D * D + 12 * att))
    return fwd, bwd


def per_step(per_geo: dict, key: str, calls: dict) -> float:
    """A per-call value summed over one step's calls (``calls``: geometry ->
    calls per step)."""
    return sum(n * per_geo[g][key] for g, n in calls.items() if g in per_geo)


def summarize(per_geo: dict, err: float, calls_by_step: dict) -> dict:
    """A kernel's line: ``ms``/``plain_ms``/``library_ms``/``bound_ms`` per
    step of the first main path that runs it (MAE before JEPA), the JEPA
    step's under ``*_jepa``, every geometry's per call under ``*_<geo>``."""
    runs = [s for s in ("mae", "jepa") if any(g in per_geo for g in calls_by_step.get(s, {}))]
    keys = [k for k in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                        "library_device_ms")
            if all(k in v for v in per_geo.values())]
    worst = max(per_geo.values(), key=lambda v: v["bound_ms"])
    r = {"max_abs_err": err, "bound_by": worst["bound_by"], "step": runs[0]}
    for k in keys:
        r[k] = per_step(per_geo, k, calls_by_step[runs[0]])
        if "jepa" in runs:
            r[f"{k}_jepa"] = per_step(per_geo, k, calls_by_step["jepa"])
        r.update({f"{k}_{g}": v[k] for g, v in per_geo.items()})
    return r


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


def check_grads(what: str, names, grads_k, grads_r) -> float:
    """Each gradient within BWD_REL of the plain version's largest magnitude;
    returns the largest error."""
    worst = 0.0
    for name, a, b in zip(names, grads_k, grads_r):
        err = (a.float() - b.float()).abs().max().item()
        lim = BWD_REL * b.float().abs().max().item() + 1e-3
        print(f"  {what} {name}: max abs err {err:.3e} (bound {lim:.3e})")
        if not err <= lim:
            fail(f"{what} backward {name}: max abs err {err} > {lim}")
        worst = max(worst, err)
    return worst


def check_kernels() -> dict:
    """Phase 3: per branch kernel and geometry, max abs error and per-call
    ms vs plain; the target geometry runs the no-grad forwards only."""
    per = {k: {} for k in KERNELS}
    errs = dict.fromkeys(KERNELS, 0.0)
    for geo, (L, D, H) in GEOMETRIES.items():
        grad = geo != "tgt"
        for kind in ("attn", "mlp"):
            x, dy, params = branch_inputs(kind, L, D, seed=L + D)
            extra = (H,) if kind == "attn" else ()
            kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
            ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref
            leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
            out_k = kern(*leaves, *extra)
            with torch.no_grad():
                out_ns = kern(x, *params, *extra)
                out_r = ref(x, *params, *extra)
            torch.cuda.synchronize()
            if not torch.equal(out_ns, out_k):
                fail(f"{kind}@{geo}: the no-stash forward differs from the stash forward")
            fwd_err = (out_k.float() - out_r.float()).abs().max().item()
            if not fwd_err <= FWD_ATOL:
                fail(f"{kind}@{geo} forward: max abs err {fwd_err} > {FWD_ATOL}")
            fwd = f"{kind}_branch_fwd" + ("" if grad or kind == "mlp" else "_nograd")
            (bf_ms, bf_by), (bb_ms, bb_by) = branch_bounds(kind, L, D, stash=grad)
            with torch.no_grad():
                t_plain = cuda_ms(lambda: ref(x, *params, *extra))
                t_ns = cuda_ms(lambda: kern(x, *params, *extra))
            t_fwd = cuda_ms(lambda: kern(*leaves, *extra)) if grad else t_ns
            per[fwd][geo] = {"ms": t_fwd, "plain_ms": t_plain, "bound_ms": bf_ms, "bound_by": bf_by}
            errs[fwd] = max(errs[fwd], fwd_err)
            line = (f"  {kind}@{geo} L={L} D={D}: fwd {t_fwd:.3f} ms (plain {t_plain:.3f}, "
                    f"bound {bf_ms:.3f})")
            if grad:
                grads_k = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
                out_rg = ref(*leaves, *extra)
                grads_r = torch.autograd.grad(out_rg, leaves, dy, retain_graph=True)
                names = ["dx", "d_ln_scale", "d_ln_bias", "d_w_a", "d_b_a", "d_w_b", "d_b_b"]
                bwd_err = check_grads(f"{kind}@{geo}", names, grads_k, grads_r)
                t_bwd = cuda_ms(lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True))
                t_pbwd = cuda_ms(lambda: torch.autograd.grad(out_rg, leaves, dy,
                                                             retain_graph=True))
                bwd = f"{kind}_branch_bwd"
                per[bwd][geo] = {"ms": t_bwd, "plain_ms": t_pbwd, "bound_ms": bb_ms,
                                 "bound_by": bb_by}
                errs[bwd] = max(errs[bwd], bwd_err)
                line += f", bwd {t_bwd:.3f} ms (plain {t_pbwd:.3f}, bound {bb_ms:.3f})"
                del grads_k, grads_r, out_rg
            else:
                line += f" (no-grad; the stash forward {cuda_ms(lambda: kern(*leaves, *extra)):.3f})"
            print(line + f"; fwd max abs err {fwd_err:.3e}", flush=True)
            del out_k, out_r, out_ns, leaves
    return {k: summarize(per[k], errs[k], STEP_CALLS) for k in KERNELS}


def gemm_products(L: int, D: int) -> dict:
    """The products of rows 1-5 at (B, L, D), F = 4D, as ``bf.gemm`` takes
    them: name -> (layout, epilogue, M, N, K, branch pass). Per block, the
    forward runs qkv, proj, fc1, fc2; the backward runs qkv and fc1 again
    and the rest."""
    M, F_ = BATCH * L, 4 * D
    return {
        "qkv": ("nt", "bias_bf16", M, 3 * D, D, "attn fwd"),
        "proj": ("nt", "bias_resid", M, D, D, "attn fwd"),
        "dWp": ("tn", "f32", D, D, M, "attn bwd"),
        "da": ("nn", "bf16", M, D, D, "attn bwd"),
        "dWqkv": ("tn", "f32", 3 * D, D, M, "attn bwd"),
        "dy1": ("nn", "f32", M, D, 3 * D, "attn bwd"),
        "fc1": ("nt", "bias_gelu", M, F_, D, "mlp fwd"),
        "fc2": ("nt", "bias_resid", M, D, F_, "mlp fwd"),
        "dW2": ("tn", "f32", D, F_, M, "mlp bwd"),
        "dz": ("nn", "gelu_bwd", M, F_, D, "mlp bwd"),
        "dW1": ("tn", "f32", F_, D, M, "mlp bwd"),
        "dy2": ("nn", "f32", M, D, F_, "mlp bwd"),
    }


def gemm_calls(name: str, grad: bool) -> int:
    """Calls of a product per block: qkv and fc1 twice with grad (the
    backward recomputes them), the backward's products only with grad."""
    if name in ("qkv", "fc1"):
        return 2 if grad else 1
    return 1 if name in ("proj", "fc2") or grad else 0


def gemm_bound(layout: str, epi: str, M: int, N: int, K: int):
    """Least time of one product: A and B read once, C written once (f32
    or bf16), the epilogue's extra tensor read (residual, pre-activation)
    or written (pre-activation) once; 2MNK operations."""
    c = M * N * (4 if epi == "f32" else 2)
    extra = {"bias_resid": 2, "bias_gelu": 2, "gelu_bwd": 2}.get(epi, 0) * M * N
    return bound(2 * (M * K + K * N) + c + extra, 2 * M * N * K)


def gemm_table() -> list:
    """Phase 3's per-GEMM table: every product of rows 1-5 at the main
    paths' shapes through ``bf.gemm``, checked against ``gemm_ref`` (each
    output within 1% of the plain version's largest magnitude), with the
    device time of its wgmma kernel alone (``gemm_sm90`` kernels; the
    weight gradients' reduction and the db1 column reduction apart), of
    ``torch.matmul`` on the same bf16 operands (a yardstick, never a route)
    and its bound; and the kernels' device time per MAE and JEPA step."""
    rows = []
    per_step = {"mae": 0.0, "jepa": 0.0}
    for geo, (L, D, _) in GEOMETRIES.items():
        grad = geo != "tgt"
        for name, (layout, epi, M, N, K, pas) in gemm_products(L, D).items():
            calls = gemm_calls(name, grad)
            if not calls:
                continue
            g = torch.Generator().manual_seed(M + N + K)
            a = torch.randn(*((K, M) if layout == "tn" else (M, K)), generator=g)
            b = torch.randn(*((N, K) if layout == "nt" else (K, N)), generator=g) * K**-0.5
            a, b = a.to(torch.bfloat16).cuda(), b.to(torch.bfloat16).cuda()
            ex = {"bias": (0.1 * torch.randn(N, generator=g)).to(torch.bfloat16).cuda(),
                  "resid": torch.randn(M, N, generator=g).to(torch.bfloat16).cuda(),
                  "z": torch.randn(M, N, generator=g).to(torch.bfloat16).cuda()}
            got = bf.gemm(a, b, layout, epi, **ex)
            want = bf.gemm_ref(a, b, layout, epi, **ex)
            torch.cuda.synchronize()
            err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
            lim = 1e-2 * max(y.float().abs().max().item() for y in want) + 1e-4
            if not err <= lim:
                fail(f"gemm {name}@{geo} ({layout} {epi}): max abs err {err} > {lim}")
            del got, want
            # one profiler session for both: the wgmma kernel, the wrapper's
            # reductions (colsum_kernel) and the rest, torch.matmul's kernels
            at, bt = (a.t() if layout == "tn" else a), (b.t() if layout == "nt" else b)
            shares: dict = {}
            device_ms(lambda: (bf.gemm(a, b, layout, epi, **ex), torch.matmul(at, bt)),
                      by_kernel=shares)
            k_ms = sum(v for k, v in shares.items() if "gemm_sm90" in k)
            red_ms = sum(v for k, v in shares.items() if "colsum" in k)
            m_ms = sum(shares.values()) - k_ms - red_ms
            total = k_ms + red_ms
            b_ms, b_by = gemm_bound(layout, epi, M, N, K)
            rows.append({"geo": geo, "product": name, "pass": pas, "layout": layout, "epi": epi,
                         "M": M, "N": N, "K": K, "calls_per_block": calls, "max_abs_err": err,
                         "kernel_ms": k_ms, "with_reductions_ms": total, "matmul_ms": m_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"  gemm {geo} {name:5s} {layout} {epi:10s} M={M} N={N} K={K}: kernel "
                  f"{k_ms:.4f} ms (with reductions {total:.4f}), matmul {m_ms:.4f}, bound "
                  f"{b_ms:.4f} ({b_by}); kernel/matmul {k_ms / m_ms:.2f}, bound share "
                  f"{b_ms / k_ms:.2f}; max abs err {err:.2e}", flush=True)
            for step, blocks in STEP_CALLS.items():
                per_step[step] += blocks.get(geo, 0) * calls * k_ms
            del a, b, ex
    torch.cuda.empty_cache()
    print(f"  GEMM kernels' device ms per step (table sum): MAE {per_step['mae']:.3f}, "
          f"JEPA {per_step['jepa']:.3f}", flush=True)
    return rows


def stack_inputs(L: int, D: int, N: int, seed: int):
    """bf16 x and dy, and N blocks' 12 f32 params each, on the card."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    F_ = 4 * D

    def block():
        return [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(3 * D, D) * D**-0.5, 0.1 * rn(3 * D),
                rn(D, D) * D**-0.5, 0.1 * rn(D), 1.0 + 0.1 * rn(D), 0.1 * rn(D),
                rn(F_, D) * D**-0.5, 0.1 * rn(F_), rn(D, F_) * F_**-0.5, 0.1 * rn(D)]

    params = [[t.cuda() for t in block()] for _ in range(N)]
    x, dy = (rn(BATCH, L, D).to(torch.bfloat16).cuda() for _ in range(2))
    return x, dy, params


def check_stack(kind: str) -> dict:
    """Phases 3d (``kind="block"``: one block per geometry) and 3e
    (``"chain"``: CHAIN_DEPTH blocks): the kernels against their plain
    versions, every backward output, and per-call times; the target
    geometry runs the no-grad forward only."""
    names = BLOCK_KERNELS if kind == "block" else CHAIN_KERNELS
    fwd, nograd, bwd = names
    per = {k: {} for k in names}
    errs = dict.fromkeys(names, 0.0)
    for geo, (L, D, H) in GEOMETRIES.items():
        grad = geo != "tgt"
        N = 1 if kind == "block" else CHAIN_DEPTH[geo]
        x, dy, params = stack_inputs(L, D, N, seed=L + D + N)
        if kind == "block":
            kern = lambda x, pl: bf.fused_block(x, pl[0], H)  # noqa: E731
            ref = lambda x, pl: bf.block_ref(x, pl[0], H)  # noqa: E731
        else:
            kern = lambda x, pl: bc.fused_block_chain(x, pl, H)  # noqa: E731
            ref = lambda x, pl: bc.chain_ref(x, pl, H)  # noqa: E731
        xl = x.clone().requires_grad_()
        pl = [[t.clone().requires_grad_() for t in p] for p in params]
        leaves = [xl] + [t for p in pl for t in p]
        out_k = kern(xl, pl)
        with torch.no_grad():
            out_ng = kern(x, params)
            out_r = ref(x, params)
            split = None
            if kind == "chain":
                split = x
                for p in params:
                    split = bf.fused_mlp_branch(bf.fused_attn_branch(split, *p[:6], H), *p[6:])
        torch.cuda.synchronize()
        if not torch.equal(out_ng, out_k):
            fail(f"{kind}@{geo}: the no-grad forward differs from the forward")
        if split is not None and not torch.equal(split, out_k):
            fail(f"chain@{geo}: the forward differs from the split kernels'")
        fwd_err = (out_k.float() - out_r.float()).abs().max().item()
        if not fwd_err <= FWD_ATOL * N:  # a rounding flipped in one block carries on
            fail(f"{kind}@{geo} forward: max abs err {fwd_err} > {FWD_ATOL * N}")
        (bf_ms, bf_by), (bb_ms, bb_by) = stack_bounds(L, D, N, stash=kind == "chain" and grad)
        with torch.no_grad():
            t_plain = cuda_ms(lambda: ref(x, params))
            t_ng = cuda_ms(lambda: kern(x, params))
        t_fwd = cuda_ms(lambda: kern(xl, pl)) if grad else t_ng
        key = fwd if grad else nograd
        per[key][geo] = {"ms": t_fwd, "plain_ms": t_plain, "bound_ms": bf_ms, "bound_by": bf_by}
        errs[key] = max(errs[key], fwd_err)
        line = (f"  {kind}@{geo} L={L} D={D} N={N}: fwd {t_fwd:.3f} ms (plain {t_plain:.3f}, "
                f"bound {bf_ms:.3f})")
        if grad:
            grads_k = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
            out_rg = ref(xl, pl)
            grads_r = torch.autograd.grad(out_rg, leaves, dy, retain_graph=True)
            gnames = ["dx"] + [f"d{i // 12}_{i % 12}" for i in range(12 * N)]
            bwd_err = check_grads(f"{kind}@{geo}", gnames, grads_k, grads_r)
            t_bwd = cuda_ms(lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True))
            t_pbwd = cuda_ms(lambda: torch.autograd.grad(out_rg, leaves, dy, retain_graph=True))
            per[bwd][geo] = {"ms": t_bwd, "plain_ms": t_pbwd, "bound_ms": bb_ms,
                             "bound_by": bb_by}
            errs[bwd] = max(errs[bwd], bwd_err)
            line += f", bwd {t_bwd:.3f} ms (plain {t_pbwd:.3f}, bound {bb_ms:.3f})"
            del grads_k, grads_r, out_rg
        else:
            line += f" (no-grad; with grad {cuda_ms(lambda: kern(xl, pl)):.3f})"
        print(line + f"; fwd max abs err {fwd_err:.3e}", flush=True)
        del out_k, out_r, out_ng, split, xl, pl, leaves
        torch.cuda.empty_cache()
    calls = STEP_CALLS if kind == "block" else CHAIN_CALLS
    return {k: summarize(per[k], errs[k], calls) for k in names}


def attention_inputs(entry: str, L: int, D: int, H: int, seed: int):
    """Unit-normal bf16 leaves of the entry's layout, and dO, on the card."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(BATCH, L, D, generator=g).to(torch.bfloat16).cuda()
                   for _ in range(4))
    if entry == "mha_stacked_qkv":
        return [torch.cat([q, k, v], dim=-1)], do
    if entry == "mha_pallas":
        return [heads_of(t, H).contiguous() for t in (q, k, v)], heads_of(do, H).contiguous()
    return [q, k, v], do


def attention_call(entry: str):
    """How the entry is called on its leaves: (fn, leaves, num_heads)."""
    if entry == "mha_pallas":
        return lambda fn, xs, H: fn(*xs)
    return lambda fn, xs, H: fn(*xs, H)


def sdpa_inputs(entry: str, leaves, do, H: int):
    """The same q, k, v and dO as separate contiguous (B, H, L, d) tensors."""
    if entry == "mha_pallas":
        qkv, doh = leaves, do
    else:
        qkv = leaves if len(leaves) == 3 else leaves[0].chunk(3, dim=-1)
        qkv, doh = [heads_of(t, H) for t in qkv], heads_of(do, H)
    return [t.detach().contiguous().clone().requires_grad_() for t in qkv], doh.contiguous()


def mha_occupancy() -> None:
    """Phase 3b: blocks per SM of the attention kernels at the decoder's
    and the encoder's head geometry, from the CUDA occupancy calculator."""
    lib = _build.load()
    for L, d in ((145, 32), (37, 24)):
        for pas in ("fwd", "bwd"):
            vals = [ctypes.c_int() for _ in range(4)]
            _build.check(lib.ssrl_mha_occupancy(L, d, int(pas == "bwd"),
                                                *(ctypes.byref(v) for v in vals)),
                         "mha_occupancy")
            blocks, warps, smem, regs = (v.value for v in vals)
            print(f"  mha {pas} at L={L}, d={d}: {blocks} blocks of {warps} warps per SM "
                  f"({blocks * warps} warps), {smem} bytes of shared memory a block, "
                  f"{regs} registers a thread", flush=True)


def check_attention() -> dict:
    """Phase 3b: per attention entry and pass, errors, times and bounds."""
    mha_occupancy()
    res = {}
    for entry, (kern, ref, _, _, where) in ATTENTION.items():
        call = attention_call(entry)
        per = {"fwd": {}, "bwd": {}}
        err = {"fwd": 0.0, "bwd": 0.0}
        for geo in where:
            L, D, H = GEOMETRIES[geo]
            leaves, do = attention_inputs(entry, L, D, H, seed=L + D)
            xs = [t.clone().requires_grad_() for t in leaves]
            out_k = call(kern, xs, H)
            grads_k = torch.autograd.grad(out_k, xs, do, retain_graph=True)
            out_r = call(ref, xs, H)
            grads_r = torch.autograd.grad(out_r, xs, do, retain_graph=True)
            with torch.no_grad():
                out_ng = call(kern, leaves, H)
            torch.cuda.synchronize()
            if not torch.equal(out_ng, out_k):
                fail(f"{entry}@{geo}: the no-grad forward differs from the forward")
            fwd_err = (out_k.float() - out_r.float()).abs().max().item()
            if not fwd_err <= FWD_ATOL:
                fail(f"{entry}@{geo} forward: max abs err {fwd_err} > {FWD_ATOL}")
            names = ["dqkv"] if len(xs) == 1 else ["dq", "dk", "dv"]
            bwd_err = check_grads(f"{entry}@{geo}", names, grads_k, grads_r)
            # the yardstick: one library call on the same (B, H, L, d) data
            qh, doh = sdpa_inputs(entry, leaves, do, H)
            out_s = F.scaled_dot_product_attention(*qh)
            with torch.no_grad():
                t_fwd = {
                    "ms": cuda_ms(lambda: call(kern, leaves, H), **ATT_TIMING),
                    "plain_ms": cuda_ms(lambda: call(ref, leaves, H), **ATT_TIMING),
                    "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*qh),
                                          **ATT_TIMING),
                }
            t_bwd = {
                "ms": cuda_ms(lambda: torch.autograd.grad(out_k, xs, do, retain_graph=True),
                              **ATT_TIMING),
                "plain_ms": cuda_ms(
                    lambda: torch.autograd.grad(out_r, xs, do, retain_graph=True),
                    **ATT_TIMING),
                "library_ms": cuda_ms(
                    lambda: torch.autograd.grad(out_s, qh, doh, retain_graph=True),
                    **ATT_TIMING),
            }
            with torch.no_grad():
                t_fwd["device_ms"] = device_ms(lambda: call(kern, leaves, H))
                t_fwd["library_device_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(*qh))
            t_bwd["device_ms"] = device_ms(
                lambda: torch.autograd.grad(out_k, xs, do, retain_graph=True))
            t_bwd["library_device_ms"] = device_ms(
                lambda: torch.autograd.grad(out_s, qh, doh, retain_graph=True))
            (bf_ms, bf_by), (bb_ms, bb_by) = attention_bounds(L, D)
            per["fwd"][geo] = {**t_fwd, "bound_ms": bf_ms, "bound_by": bf_by}
            per["bwd"][geo] = {**t_bwd, "bound_ms": bb_ms, "bound_by": bb_by}
            err["fwd"], err["bwd"] = max(err["fwd"], fwd_err), max(err["bwd"], bwd_err)
            print(f"  {entry}@{geo} L={L} D={D}: fwd {t_fwd['ms']:.3f} ms (plain "
                  f"{t_fwd['plain_ms']:.3f}, sdpa {t_fwd['library_ms']:.3f}, bound "
                  f"{bf_ms:.3f}), bwd {t_bwd['ms']:.3f} ms (plain {t_bwd['plain_ms']:.3f}, "
                  f"sdpa {t_bwd['library_ms']:.3f}, bound {bb_ms:.3f}); device fwd "
                  f"{t_fwd['device_ms']:.4f} (sdpa {t_fwd['library_device_ms']:.4f}), bwd "
                  f"{t_bwd['device_ms']:.4f} (sdpa {t_bwd['library_device_ms']:.4f}); "
                  f"fwd max abs err {fwd_err:.3e}", flush=True)
            del out_k, out_r, out_s, grads_k, grads_r, xs, qh
        for pas in ("fwd", "bwd"):
            # per MAE step (4 encoder + 2 decoder calls), as if on its route
            r = summarize(per[pas], err[pas], {"mae": STEP_CALLS["mae"]})
            res[f"{entry}_{pas}"] = {**r, "step": "mae"}
    return res


def embed_inputs(K, seed: int):
    """Patches, embedding params and dy at the flagship geometry, on the
    card; the index holds CLS first and K - 1 distinct patch tokens per
    image, unsorted (the JEPA context's argsort order)."""
    g = torch.Generator().manual_seed(seed)
    N, Pc, D = EMBED_N, EMBED_PC, EMBED_D
    patches = (torch.rand(BATCH, N, Pc, generator=g) * 2 - 1).to(torch.bfloat16)
    params = [torch.randn(D, Pc, generator=g) * Pc**-0.5, 0.02 * torch.randn(D, generator=g),
              0.02 * torch.randn(1, 1, D, generator=g), 0.02 * torch.randn(1, N + 1, D, generator=g)]
    idx = None
    if K is not None:
        perm = torch.argsort(torch.rand(BATCH, N, generator=g), dim=-1)[:, :K - 1] + 1
        idx = torch.cat([torch.zeros(BATCH, 1, dtype=torch.long), perm], dim=1).cuda()
    dy = torch.randn(BATCH, N + 1 if K is None else K, D, generator=g).to(torch.bfloat16)
    return patches.cuda(), [p.cuda() for p in params], idx, dy.cuda()


def embed_bounds(K):
    """Per-call bounds of the embed kernels: (fwd, bwd without dpatches, bwd
    with dpatches). The kept non-CLS rows of the patches are read once, the
    (B, K, D) output or dy once, the bf16 weight and bias, the f32 CLS and
    position rows and the int64 index once; f32 dW, db and d(cls_pos)
    written once (dpatches in full: zeros outside the kept rows). Operations:
    2·rows·Pc·D per product (forward; dW; dpatches)."""
    N, Pc, D = EMBED_N, EMBED_PC, EMBED_D
    L = N + 1
    k = L if K is None else K
    rows = BATCH * (k - 1)  # kept rows that are patches (CLS is not)
    idx = 0 if K is None else BATCH * k * 8
    gemm = 2 * rows * Pc * D
    fwd = bound(rows * Pc * 2 + BATCH * k * D * 2 + D * Pc * 2 + D * 2 + L * D * 4 + idx, gemm)
    grads_out = D * Pc * 4 + D * 4 + L * D * 4
    bwd = bound(BATCH * k * D * 2 + rows * Pc * 2 + idx + grads_out, gemm)
    bwd_dp = bound(BATCH * k * D * 2 + rows * Pc * 2 + D * Pc * 2 + idx + grads_out
                   + BATCH * N * Pc * 2, 2 * gemm)
    return fwd, bwd, bwd_dp


def check_embed() -> dict:
    """Phase 3c: the embed kernels against the plain version at the three
    index forms, every output of the backward, and per-call times."""
    per = {"fwd": {}, "bwd": {}}
    err = {"fwd": 0.0, "bwd": 0.0}
    for geo, K in EMBED_GEOS.items():
        patches, params, idx, dy = embed_inputs(K, seed=7 + (K or 0))
        leaves = [p.clone().requires_grad_() for p in params]
        before = dict(ef.LAUNCHES)
        out_k = ef.fused_patch_embed(patches, *leaves, idx)
        grads_k = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
        if ef.LAUNCHES != {"patch_embed_fwd": before["patch_embed_fwd"] + 1,
                           "patch_embed_bwd": before["patch_embed_bwd"] + 1}:
            fail(f"embed@{geo}: launches {ef.LAUNCHES} after one forward and backward "
                 f"from {before}")
        pl = patches.clone().requires_grad_()
        out_kp = ef.fused_patch_embed(pl, *leaves, idx)
        grads_kp = torch.autograd.grad(out_kp, [pl] + leaves, dy, retain_graph=True)
        out_r = ef.fused_patch_embed_ref(pl, *leaves, idx)
        grads_r = torch.autograd.grad(out_r, [pl] + leaves, dy, retain_graph=True)
        with torch.no_grad():
            out_ng = ef.fused_patch_embed(patches, *params, idx)
        torch.cuda.synchronize()
        if not (torch.equal(out_ng, out_k) and torch.equal(out_kp, out_k)):
            fail(f"embed@{geo}: the no-grad forward differs from the forward")
        if not all(torch.equal(a, b) for a, b in zip(grads_k, grads_kp[1:])):
            fail(f"embed@{geo}: the parameter gradients change when dpatches is computed")
        fwd_err = (out_k.float() - out_r.float()).abs().max().item()
        if not fwd_err <= FWD_ATOL:
            fail(f"embed@{geo} forward: max abs err {fwd_err} > {FWD_ATOL}")
        bwd_err = check_grads(f"embed@{geo}", ["dpatches", "dw", "db", "dcls", "dpos"],
                              grads_kp, grads_r)
        # the yardstick: a gather of the kept patch rows, then torch.matmul
        wb = params[0].to(torch.bfloat16)
        src = None if idx is None else (idx.clamp_min(1) - 1)[..., None].expand(-1, -1, EMBED_PC)
        rows = (lambda: patches) if idx is None else (lambda: patches.gather(1, src))
        dyf = dy.reshape(-1, EMBED_D)
        with torch.no_grad():
            t_fwd = {"ms": cuda_ms(lambda: ef.fused_patch_embed(patches, *params, idx)),
                     "plain_ms": cuda_ms(lambda: ef.fused_patch_embed_ref(patches, *params, idx)),
                     "library_ms": cuda_ms(lambda: torch.matmul(rows(), wb.t()))}
            t_lib_bwd = cuda_ms(lambda: torch.matmul(
                dyf.t()[:, : BATCH * EMBED_N] if idx is None else dyf.t(),
                rows().reshape(-1, EMBED_PC)))
        out_rn = ef.fused_patch_embed_ref(patches, *leaves, idx)
        t_bwd = {"ms": cuda_ms(lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True)),
                 "plain_ms": cuda_ms(lambda: torch.autograd.grad(out_rn, leaves, dy,
                                                                 retain_graph=True)),
                 "library_ms": t_lib_bwd}
        t_dp = cuda_ms(lambda: torch.autograd.grad(out_kp, [pl] + leaves, dy, retain_graph=True))
        fwd_shares, bwd_shares = {}, {}
        with torch.no_grad():
            t_fwd["device_ms"] = device_ms(lambda: ef.fused_patch_embed(patches, *params, idx),
                                           by_kernel=fwd_shares)
            t_fwd["library_device_ms"] = device_ms(lambda: torch.matmul(rows(), wb.t()))
            t_bwd["library_device_ms"] = device_ms(lambda: torch.matmul(
                dyf.t()[:, : BATCH * EMBED_N] if idx is None else dyf.t(),
                rows().reshape(-1, EMBED_PC)))
        t_bwd["device_ms"] = device_ms(
            lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True), by_kernel=bwd_shares)
        (bf_ms, bf_by), (bb_ms, bb_by), (bd_ms, _) = embed_bounds(K)
        per["fwd"][geo] = {**t_fwd, "bound_ms": bf_ms, "bound_by": bf_by}
        per["bwd"][geo] = {**t_bwd, "bound_ms": bb_ms, "bound_by": bb_by,
                           "ms_dpatches": t_dp, "bound_ms_dpatches": bd_ms}
        err["fwd"], err["bwd"] = max(err["fwd"], fwd_err), max(err["bwd"], bwd_err)
        print(f"  embed@{geo} K={K}: fwd {t_fwd['ms']:.3f} ms (plain {t_fwd['plain_ms']:.3f}, "
              f"gather+matmul {t_fwd['library_ms']:.3f}, bound {bf_ms:.4f}), bwd "
              f"{t_bwd['ms']:.3f} ms (plain {t_bwd['plain_ms']:.3f}, gather+matmul "
              f"{t_lib_bwd:.3f}, bound {bb_ms:.4f}), bwd with dpatches {t_dp:.3f} ms "
              f"(bound {bd_ms:.4f}); device fwd {t_fwd['device_ms']:.4f} (gather+matmul "
              f"{t_fwd['library_device_ms']:.4f}), bwd {t_bwd['device_ms']:.4f} "
              f"(gather+matmul {t_bwd['library_device_ms']:.4f}); fwd max abs err "
              f"{fwd_err:.3e}", flush=True)
        print(f"    device fwd by kernel: {kernel_shares(fwd_shares)}")
        print(f"    device bwd by kernel: {kernel_shares(bwd_shares)}", flush=True)
        del out_k, out_kp, out_r, out_rn, grads_k, grads_kp, grads_r
    res = {}
    for pas in ("fwd", "bwd"):
        r = summarize(per[pas], err[pas], EMBED_CALLS[pas])
        for g, v in per[pas].items():
            r.update({f"{k}_{g}": x for k, x in v.items() if k.endswith("dpatches")})
        res[f"patch_embed_{pas}"] = r
    return res


def launch_counts() -> dict:
    return {**bf.LAUNCHES, **bc.LAUNCHES, **core.LAUNCHES, **ef.LAUNCHES}


def reset_counts() -> None:
    bf.reset_launch_counts()
    bc.reset_launch_counts()
    core.reset_launch_counts()
    ef.reset_launch_counts()


def expected(per_step: dict, steps: int = 1) -> dict:
    """Every counter: ``per_step`` launches per step, the others none."""
    want = dict.fromkeys(launch_counts(), 0)
    want.update({k: v * steps for k, v in per_step.items()})
    return want


def mae_launches(impl: str, fused_embed: bool = False) -> dict:
    """Launches per MAE step on the main path of ``impl``: one forward and
    one backward of its kernels per block (6 blocks), or per stack (2
    chains), with the fused embed one of each more."""
    names = ["attn_branch_fwd", "attn_branch_bwd", "mlp_branch_fwd", "mlp_branch_bwd"]
    if impl == "chain":
        names = ["chain_fwd", "chain_bwd"]
    elif impl == "block":
        names = ["block_fwd", "block_bwd"]
    elif impl != "auto":
        names = [f"{IMPL_ENTRY[impl]}_{pas}" for pas in ("fwd", "bwd")]
    n = len(CHAIN_CALLS["mae"]) if impl == "chain" else sum(STEP_CALLS["mae"].values())
    want = dict.fromkeys(names, n)
    if fused_embed:
        want.update(patch_embed_fwd=1, patch_embed_bwd=1)
    return want


def jepa_launches(fused_embed: bool, impl: str = "auto") -> dict:
    """Launches per JEPA step: the context encoder's 4 and the predictor's 2
    blocks forward and backward, the target encoder's 4 blocks through the
    no-grad forwards (under "chain" one chain per stack); with the fused
    embed two forwards (context, target) and one backward (context)."""
    c = STEP_CALLS["jepa"]
    grad = c["ctx"] + c["pred"]
    want = {"attn_branch_fwd": grad, "attn_branch_fwd_nograd": c["tgt"], "attn_branch_bwd": grad,
            "mlp_branch_fwd": grad + c["tgt"], "mlp_branch_bwd": grad}
    if impl == "block":
        want = {"block_fwd": grad, "block_fwd_nograd": c["tgt"], "block_bwd": grad}
    elif impl == "chain":
        want = {"chain_fwd": 2, "chain_fwd_nograd": 1, "chain_bwd": 2}
    if fused_embed:
        want.update(patch_embed_fwd=2, patch_embed_bwd=1)
    return want


@contextlib.contextmanager
def fused_embed(on: bool):
    """``SSRL_FUSED_EMBED=1`` inside the block, unset otherwise."""
    old = os.environ.pop("SSRL_FUSED_EMBED", None)
    if on:
        os.environ["SSRL_FUSED_EMBED"] = "1"
    try:
        yield
    finally:
        os.environ.pop("SSRL_FUSED_EMBED", None)
        if old is not None:
            os.environ["SSRL_FUSED_EMBED"] = old


def flagship_images(seed: int = 0):
    images = np.random.default_rng(seed).integers(0, 256, (BATCH, 96, 96, 3)).astype(np.uint8)
    return {"image": torch.from_numpy(images).cuda(), "weight": torch.ones(BATCH, device="cuda")}


def timed_steps(task, state, batch, name: str, what: str):
    """WARMUP steps, then STEPS steps between zeroed and read launch counts;
    returns (state, per-step sums, launches, ms/step)."""
    ctx = task.epoch_context(0)
    torch.cuda.reset_peak_memory_stats()
    sums = []
    for _ in range(WARMUP):
        state, s = task.train_step(state, batch, 0, ctx)
        sums.append(s)
    torch.cuda.synchronize()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        state, s = task.train_step(state, batch, 0, ctx)
        sums.append(s)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ms = start.elapsed_time(end) / STEPS
    print(f"  {what} B={BATCH} bf16 on {name}: {ms:.3f} ms/step (CUDA events), "
          f"{BATCH / ms * 1e3:.1f} img/s; wall {wall / STEPS * 1e3:.3f} ms/step; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    losses = [float(s["loss_sum"]) / BATCH for s in sums]
    print(f"  losses: {[round(v, 5) for v in losses]}")
    print(f"  launches over {STEPS} steps: {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: non-finite loss: {losses}")
    return state, sums, launches


def check_moved(before: dict, after: dict, what: str) -> None:
    moved = sum(int(not torch.equal(before[k], v)) for k, v in after.items())
    if moved != len(before):
        fail(f"{what}: only {moved} of {len(before)} tensors changed")


def mae_step(model_cfg: dict, name: str, impl: str, fused: bool = False) -> dict:
    """Phases 4, 6, 7, 9, 11, 12: the flagship step through MAETask on the
    card."""
    with fused_embed(fused):
        task = MAETask(model_cfg, PRE_CFG, dtype=torch.bfloat16, device="cuda", attn_impl=impl)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        what = f"MAE step attn_impl={impl}" + (" SSRL_FUSED_EMBED=1" if fused else "")
        state, _, launches = timed_steps(task, state, flagship_images(), name, what)
    check_moved(before, state.params, what)
    want = expected(mae_launches(impl, fused), STEPS)
    if launches != want:
        fail(f"{what}: launches in {STEPS} steps {launches}, expected {want}")
    del task, state
    torch.cuda.empty_cache()
    return launches


def cpu_agreement(model_cfg: dict, impl: str) -> None:
    """Phases 5-7, 11, 12: B=16, same weights and draws, kernels vs plain
    CPU path."""
    n = 16
    gpu = MAETask(model_cfg, PRE_CFG, dtype=torch.bfloat16, device="cuda", attn_impl=impl)
    cpu = MAETask(model_cfg, PRE_CFG, dtype=torch.bfloat16, device="cpu", attn_impl=impl)
    gs, cs = gpu.init_state(1), cpu.init_state(1)
    cpu.model.load_state_dict(gpu.model.state_dict())
    images = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)
    )
    ctx = gpu.epoch_context(0)
    draws = gpu.draw(gs.generator, n, ctx)
    weight = torch.ones(n)
    before = {k: v.detach().cpu().clone() for k, v in cs.params.items()}
    reset_counts()
    _, s_gpu = gpu.train_step(gs, {"image": images.cuda(), "weight": weight.cuda()},
                              0, ctx, draws)
    launched = launch_counts()
    _, s_cpu = cpu.train_step(cs, {"image": images, "weight": weight}, 0, ctx,
                              tuple(d.cpu() for d in draws))
    if launch_counts() != launched or launched != expected(mae_launches(impl)):
        fail(f"launch counts: {launch_counts()} (the GPU step must launch one of each "
             f"kernel of attn_impl={impl} per block, the CPU step none)")
    lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
    print(f"  attn_impl={impl} B={n} loss: kernels on the card {lg:.6f}, "
          f"plain on the CPU {lc:.6f}")
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


def jepa_step(model_cfg: dict, jepa_cfg: dict, name: str, fused: bool,
              impl: str = "auto") -> dict:
    """Phases 8, 9, 13, 14: the flagship JEPA step through JEPATask on the
    card."""
    what = f"JEPA step attn_impl={impl}" + (" SSRL_FUSED_EMBED=1" if fused else "")
    with fused_embed(fused):
        task = JEPATask(model_cfg, jepa_cfg, dtype=torch.bfloat16, device="cuda",
                        attn_impl=impl)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        extra0 = {k: v.clone() for k, v in state.extra.items()}
        state, sums, launches = timed_steps(task, state, flagship_images(), name, what)
    check_moved(before, state.params, what)
    check_moved(extra0, state.extra, what + " (EMA target)")
    metrics = task.epoch_metrics_from_sums(
        {k: float(v) for k, v in sums[-1].items()}, "train")
    print(f"  last step: {metrics}")
    for k in ("train_pred_std", "train_target_std", "train_pred_target_cos", "train_ema_drift"):
        if not math.isfinite(metrics[k]):
            fail(f"{what}: {k} = {metrics[k]}")
    if not metrics["train_ema_drift"] > 0:
        fail(f"{what}: the EMA target did not drift from the encoder ({metrics})")
    want = expected(jepa_launches(fused, impl), STEPS)
    if launches != want:
        fail(f"{what}: launches in {STEPS} steps {launches}, expected {want}")
    del task, state
    torch.cuda.empty_cache()
    return launches


def jepa_cpu_agreement(model_cfg: dict, jepa_cfg: dict, impl: str = "auto") -> None:
    """Phases 10, 13, 14: B=16, same weights, EMA and draws, kernels vs
    plain CPU."""
    n = 16
    gpu = JEPATask(model_cfg, jepa_cfg, dtype=torch.bfloat16, device="cuda", attn_impl=impl)
    cpu = JEPATask(model_cfg, jepa_cfg, dtype=torch.bfloat16, device="cpu", attn_impl=impl)
    gs, cs = gpu.init_state(1), cpu.init_state(1)
    cpu.model.load_state_dict(gpu.model.state_dict())
    cs.extra = {k: v.cpu().clone() for k, v in gs.extra.items()}
    images = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (n, 96, 96, 3)).astype(np.uint8))
    draws = gpu.draw(gs.generator, n, None)
    weight = torch.ones(n)
    reset_counts()
    _, s_gpu = gpu.train_step(gs, {"image": images.cuda(), "weight": weight.cuda()},
                              0, None, draws)
    launched = launch_counts()
    _, s_cpu = cpu.train_step(cs, {"image": images, "weight": weight}, 0, None,
                              tuple(d.cpu() for d in draws))
    if launch_counts() != launched or launched != expected(jepa_launches(False, impl)):
        fail(f"launch counts: {launch_counts()} (the GPU JEPA step must launch "
             f"{jepa_launches(False, impl)}, the CPU step nothing)")
    lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
    print(f"  JEPA attn_impl={impl} B={n} loss: kernels on the card {lg:.6f}, "
          f"plain on the CPU {lc:.6f}")
    if not abs(lg - lc) <= LOSS_RTOL * abs(lc):
        fail(f"JEPA loss disagrees: {lg} vs {lc} (rtol {LOSS_RTOL})")
    lr = s_cpu["lr"]
    worst = max((gs.params[k].detach().cpu() - cs.params[k].detach()).abs().max().item()
                for k in cs.params)
    print(f"  after one step: max |param gpu - cpu| {worst:.3e}, lr {lr:.3e}")
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

    print("phase 3: branch kernels vs plain versions (B=768, bf16)", flush=True)
    res = check_kernels()
    print("phase 3: the branch GEMM per product vs gemm_ref and torch.matmul", flush=True)
    print(json.dumps({"gemm_table": gemm_table()}), flush=True)
    print("phase 3b: attention kernels vs plain versions (B=768, bf16)", flush=True)
    res.update(check_attention())
    print("phase 3c: patch-embed kernels vs plain version (B=768, bf16)", flush=True)
    res.update(check_embed())
    print("phase 3d: whole-block kernels vs plain version (B=768, bf16)", flush=True)
    res.update(check_stack("block"))
    print("phase 3e: chained-block kernels vs plain version (B=768, bf16)", flush=True)
    res.update(check_stack("chain"))

    cfg = load_config(REPO / "configs" / "mae.yaml")
    model_cfg = cfg["model"]
    jepa_cfg = {**cfg["jepa"], "batch_size": BATCH}
    launches = dict.fromkeys(launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for phase, impl in ((4, "auto"), (6, "packed"), (7, "pallas")):
        print(f"phase {phase}: MAE pretraining step, attn_impl={impl}", flush=True)
        add(mae_step(model_cfg, name, impl))
        print(f"phase {5 if impl == 'auto' else phase}: B=16 step, attn_impl={impl}, "
              "kernels vs plain CPU path", flush=True)
        cpu_agreement(model_cfg, impl)
    print("phase 8: JEPA pretraining step, attn_impl=auto", flush=True)
    add(jepa_step(model_cfg, jepa_cfg, name, fused=False))
    print("phase 9: JEPA and MAE steps with SSRL_FUSED_EMBED=1", flush=True)
    add(jepa_step(model_cfg, jepa_cfg, name, fused=True))
    add(mae_step(model_cfg, name, "auto", fused=True))
    print("phase 10: B=16 JEPA step, kernels vs plain CPU path", flush=True)
    jepa_cpu_agreement(model_cfg, jepa_cfg)
    for phase, impl in ((11, "block"), (12, "chain")):
        print(f"phase {phase}: MAE pretraining step, attn_impl={impl}, then B=16 "
              "kernels vs plain CPU path", flush=True)
        add(mae_step(model_cfg, name, impl))
        cpu_agreement(model_cfg, impl)
    for phase, impl in ((13, "block"), (14, "chain")):
        print(f"phase {phase}: JEPA pretraining step, attn_impl={impl}, then B=16 "
              "kernels vs plain CPU path", flush=True)
        add(jepa_step(model_cfg, jepa_cfg, name, fused=False, impl=impl))
        jepa_cpu_agreement(model_cfg, jepa_cfg, impl)

    rows = [(k, f"ssrl_vit_mae_jepa_torch/csrc/{src}", replaces)
            for k, (src, replaces, _) in KERNELS.items()]
    rows += [(f"{entry}_{pas}", "ssrl_vit_mae_jepa_torch/csrc/mha.cu", replaces)
             for entry, (*_, r_fwd, r_bwd, _) in ATTENTION.items()
             for pas, replaces in (("fwd", r_fwd), ("bwd", r_bwd))]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/patch_embed.cu", replaces)
             for k, replaces in EMBED_KERNELS.items()]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/fused_block.cu", replaces)
             for k, replaces in BLOCK_KERNELS.items()]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/block_chain.cu", replaces)
             for k, replaces in CHAIN_KERNELS.items()]
    kernels = []
    for k, src, replaces in rows:
        r = res[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **{kk: v for kk, v in r.items() if kk not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
