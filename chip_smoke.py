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
  3b. the four attention entries of ``csrc/mha.cu``, forward and backward,
     at the encoder and decoder shapes (``mha_stacked`` also at the JEPA
     predictor's L=145, D=96), against their plain versions on the card,
     with the kernel's, the plain version's and
     ``F.scaled_dot_product_attention``'s times (the yardstick, never a
     route of the port);
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
     branch kernel.

Each main-path run (phases 4, 6 and 7) zeroes every launch count just
before it and reads them just after. ``mha_stacked`` and ``mha_packed`` lie
on none of these paths (the JAX package reaches them from the JEPA
predictor's auto route and by direct calls); phase 3b drives them.

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

import torch.nn.functional as F

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.ops import attention_core as core
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.ops.attention_core import heads_of
from ssrl_vit_mae_jepa_torch.ops.attention_heads import mha_pallas, mha_pallas_ref
from ssrl_vit_mae_jepa_torch.ops.attention_packed import mha_packed, mha_packed_ref
from ssrl_vit_mae_jepa_torch.ops.attention_stacked import (
    mha_stacked,
    mha_stacked_qkv,
    mha_stacked_qkv_ref,
    mha_stacked_ref,
)
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
_TPU = "ssrl_vit_mae_jepa_tpu/ops/"
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
PRED = (145, 96, 6)  # the JEPA predictor's L, D, H
# phase 3b's CUDA-event means: more warm-up than phase 3, since the first
# backward timed after phase 3 ran up to 2x slow in one run
ATT_TIMING = {"iters": 30, "warmup": 10}
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


def bound(nbytes: float, flops: float):
    """(ms, what bounds it): the least time for the work at the card's peaks."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def branch_bounds(kind: str, L: int, D: int):
    """Per-call (fwd, bwd) bounds of a branch kernel at (B, L, D): bf16
    activations read and written once, weights once (bf16 in, f32 grads out),
    and the GEMM operations the function needs (the backward recomputes the
    first GEMM from x, as it must: only x is an input)."""
    M = BATCH * L
    act = M * D * 2
    if kind == "attn":  # qkv 6MD^2 + attention 4BL^2D + proj 2MD^2
        w = 4 * D * D
        fwd = bound(3 * act + 2 * w, 8 * M * D * D + 4 * BATCH * L * L * D)
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


def step_sum(per_geo: dict, key: str):
    """Per MAE step (4 encoder + 2 decoder calls) of a per-geometry value."""
    return sum(depth * per_geo[g][key] for g, (*_, depth) in GEOMETRIES.items())


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
            for (pas, err), (bms, by) in zip((("fwd", fwd_err), ("bwd", bwd_err)),
                                             branch_bounds(kind, L, D)):
                r = res[f"{kind}_branch_{pas}"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ms"] += depth * times[pas]
                r["plain_ms"] += depth * times[f"plain_{pas}"]
                r["bound_ms"] = r.get("bound_ms", 0.0) + depth * bms
                r["bound_by"] = by if geo == "dec" else r.get("bound_by", by)
                r[f"ms_{geo}"] = times[pas]
                r[f"plain_ms_{geo}"] = times[f"plain_{pas}"]
            del out_k, out_r, grads_k, grads_r, leaves
    return res


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


def check_attention() -> dict:
    """Phase 3b: per attention entry and pass, errors, times and bounds."""
    res = {}
    geos = {**{g: v[:3] for g, v in GEOMETRIES.items()}, "pred": PRED}
    for entry, (kern, ref, _, _, where) in ATTENTION.items():
        call = attention_call(entry)
        per = {"fwd": {}, "bwd": {}}
        err = {"fwd": 0.0, "bwd": 0.0}
        for geo in where:
            L, D, H = geos[geo]
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
            bwd_err = 0.0
            names = ["dqkv"] if len(xs) == 1 else ["dq", "dk", "dv"]
            for gname, a, b in zip(names, grads_k, grads_r):
                e = (a.float() - b.float()).abs().max().item()
                lim = BWD_REL * b.float().abs().max().item() + 1e-3
                print(f"  {entry}@{geo} {gname}: max abs err {e:.3e} (bound {lim:.3e})")
                if not e <= lim:
                    fail(f"{entry}@{geo} backward {gname}: max abs err {e} > {lim}")
                bwd_err = max(bwd_err, e)
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
            (bf_ms, bf_by), (bb_ms, bb_by) = attention_bounds(L, D)
            per["fwd"][geo] = {**t_fwd, "bound_ms": bf_ms, "bound_by": bf_by}
            per["bwd"][geo] = {**t_bwd, "bound_ms": bb_ms, "bound_by": bb_by}
            err["fwd"], err["bwd"] = max(err["fwd"], fwd_err), max(err["bwd"], bwd_err)
            print(f"  {entry}@{geo} L={L} D={D}: fwd {t_fwd['ms']:.3f} ms (plain "
                  f"{t_fwd['plain_ms']:.3f}, sdpa {t_fwd['library_ms']:.3f}, bound "
                  f"{bf_ms:.3f}), bwd {t_bwd['ms']:.3f} ms (plain {t_bwd['plain_ms']:.3f}, "
                  f"sdpa {t_bwd['library_ms']:.3f}, bound {bb_ms:.3f}); fwd max abs err "
                  f"{fwd_err:.3e}", flush=True)
            del out_k, out_r, out_s, grads_k, grads_r, xs, qh
        for pas in ("fwd", "bwd"):
            p = per[pas]
            r = {"max_abs_err": err[pas], "bound_by": p["dec"]["bound_by"]}
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                r[key] = step_sum(p, key)
            for geo, vals in p.items():
                r.update({f"{key}_{geo}": vals[key] for key in ("ms", "plain_ms", "library_ms")})
            res[f"{entry}_{pas}"] = r
    return res


def launch_counts() -> dict:
    return {**bf.LAUNCHES, **core.LAUNCHES}


def reset_counts() -> None:
    bf.reset_launch_counts()
    core.reset_launch_counts()


def expected_launches(impl: str, blocks: int) -> dict:
    """Launches per step on the main path of ``impl``: one forward and one
    backward of its kernels per block, none of any other."""
    want = dict.fromkeys(launch_counts(), 0)
    names = list(KERNELS) if impl == "auto" else [
        f"{IMPL_ENTRY[impl]}_{pas}" for pas in ("fwd", "bwd")]
    for k in names:
        want[k] = blocks
    return want


def mae_step(model_cfg: dict, name: str, impl: str) -> dict:
    """Phases 4, 6, 7: the flagship step through MAETask on the card."""
    task = MAETask(model_cfg, PRE_CFG, dtype=torch.bfloat16, device="cuda", attn_impl=impl)
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
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        state, sums = task.train_step(state, batch, 0, ctx)
        losses.append(sums["loss_sum"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ms = start.elapsed_time(end) / STEPS
    losses = [float(v) / BATCH for v in losses]
    print(f"  MAE step attn_impl={impl} B={BATCH} bf16 on {name}: {ms:.3f} ms/step (CUDA events), "
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
    want = {k: v * STEPS for k, v in expected_launches(impl, blocks).items()}
    if launches != want:
        fail(f"attn_impl={impl}: launches in {STEPS} steps {launches}, expected {want}")
    del task, state
    torch.cuda.empty_cache()
    return launches


def cpu_agreement(model_cfg: dict, impl: str) -> None:
    """Phases 5-7: B=16, same weights and draws, kernels vs plain CPU path."""
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
    blocks = sum(depth for *_, depth in GEOMETRIES.values())
    if launch_counts() != launched or launched != expected_launches(impl, blocks):
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
    print("phase 3b: attention kernels vs plain versions (B=768, bf16)", flush=True)
    res.update(check_attention())

    model_cfg = yaml.safe_load((REPO / "configs" / "mae.yaml").read_text())["model"]
    launches = dict.fromkeys(launch_counts(), 0)
    for phase, impl in ((4, "auto"), (6, "packed"), (7, "pallas")):
        print(f"phase {phase}: MAE pretraining step, attn_impl={impl}", flush=True)
        for k, v in mae_step(model_cfg, name, impl).items():
            launches[k] += v
        print(f"phase {5 if impl == 'auto' else phase}: B=16 step, attn_impl={impl}, "
              "kernels vs plain CPU path", flush=True)
        cpu_agreement(model_cfg, impl)

    kernels = []
    rows = [(k, f"ssrl_vit_mae_jepa_torch/csrc/{src}", replaces)
            for k, (src, replaces) in KERNELS.items()]
    rows += [(f"{entry}_{pas}", "ssrl_vit_mae_jepa_torch/csrc/mha.cu", replaces)
             for entry, (*_, r_fwd, r_bwd, _) in ATTENTION.items()
             for pas, replaces in (("fwd", r_fwd), ("bwd", r_bwd))]
    for k, src, replaces in rows:
        r = res[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            # per training step: 4 encoder calls + 2 decoder calls
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **({"sdpa_ms": r["library_ms"]} if "library_ms" in r else {}),
            **{kk: v for kk, v in r.items()
               if kk.startswith(("ms_", "plain_ms_", "library_ms_"))},
        })
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
