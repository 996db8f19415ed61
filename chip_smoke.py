#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: kernels, then the MAE and JEPA
pretraining steps, then the classifier stage and the engine under it, then
the port's CLIs, then the lineage paths of the step and data parallelism,
then the bench's steady-state mode (the step as a CUDA-graph replay), then
checkpoint fidelity.

Run from the repository root on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``ssrl_vit_mae_jepa_torch/csrc``;
  3. at the main paths' shapes (B=768, H=6, F=4D, bf16: the MAE encoder
     L=37, D=144 and decoder L=145, D=192; the JEPA context encoder L=45,
     D=144, predictor L=145, D=96 and target encoder L=145, D=144, the
     last under no-grad; the classifier's encoder "cls", L=145, D=144 with
     its backward) each branch kernel, forward and all seven backward
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
  3f. the f32 forwards of ``csrc/branch_f32.cu`` (the attention branch
     without stash and the MLP branch, f32 throughout, TF32 off) against
     their plain versions at the feature extractor's (256, 145, 144) and the
     reconstruction's (8, 37, 144) and (8, 145, 192), within 5e-5, with the
     kernel's, the plain version's and the bound's times;
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
  15. the flagship classifier step through ``ClassifierTask``
     (configs/mae.yaml's model and train sections, B=768, bf16,
     augmentation on, auto) under the full fine-tune, the linear probe
     (``freeze_encoder``) and ``unfreeze_last_layers=2``, then its eval
     step: finite losses, every trainable tensor moved and every frozen one
     bit-identical, and per step exactly the launches of ``CLS_LAUNCHES``
     (the frozen blocks through the no-grad attention forward, no
     backward);
  16. the same three steps and the eval step at B=16 on the card and
     through the plain path on the CPU, from the same weights and draws:
     the losses within rtol 2e-2, the eval's ``acc_sum`` within 1;
  17. the stage end to end through the port's entry points on a synthetic
     STL-10 written by ``write_synthetic_stl10`` (texture signal):
     ``Trainer.fit`` of MAE for 2 epochs at B=768 (``best.ckpt``,
     ``last.ckpt``, ``metrics.jsonl``), ``encoder_params_from_checkpoint``
     of its ``best.ckpt`` merged into a classifier, ``Trainer.fit`` of the
     full fine-tune for 2 epochs at B=256 and ``Trainer.test``, a resume
     from ``last.ckpt`` at the next epoch, and the exact launches of the
     whole phase; beside it, the host loader's sustained img/s to the card
     at B=768 and B=2000.
  18. the CLIs (``ssrl_vit_mae_jepa_torch/scripts``) at configs/mae.yaml's
     widths on a synthetic STL-10 (texture) written by the data CLI: as
     processes of their own, on their default device (the card),
     pretrain_mae (B=768, 2 epochs), train_mae from its best.ckpt (B=256, 2
     epochs), evaluate_classifier (test_acc in [0, 1]) and pretrain_jepa
     (B=768, 1 epoch), every file of their output layout present; in this
     process, train_mae from vit-jepa.pt, knn_eval, extract_features and
     reconstruct_batch with exact launches (the f32 kernels only for the
     last three), the last two held to the same functions on the CPU at
     f32; then one cell of each ablation driver.
  19. the lineage paths at B=768 (bf16, auto): the MAE step with
     augmentation off (``eval_transform`` images, no augment draws), with
     ``SSRL_AUG_PATCHES=0`` (augmented images that the models patchify) and
     with ``SSRL_MAE_DENSE_LOSS=1`` (``forward_dense``); the JEPA step with
     augmentation off and with ``SSRL_JEPA_DENSE_LOSS=1``; the classifier's
     full fine-tune with augmentation off. Each with ms/step and exactly the
     launches of phases 4, 8 and 15, then at B=16 against the plain CPU path
     (loss within rtol 2e-2, every gradient within 10%); a
     ``{"lineage_ms": {...}}`` line.
  20. data parallelism on the card: (a) a one-rank ``nccl`` group in this
     process, whose MAE and JEPA steps over the data axis equal the steps
     without a group bit for bit (deterministic algorithms on, same seed,
     so the port's own draws); (b) two ranks as processes of their own
     (``chip_smoke.py --dp-worker``) sharing the card over ``gloo`` (which
     takes CUDA tensors for ``all_reduce`` and ``broadcast``; ``nccl``
     refuses two ranks on one device), 384 rows each of the global 768:
     loss within rtol 2e-2 and every gradient within 10% of this process's
     step on all 768, exact launches per rank, and rank 0's params and EMA
     target, broadcast, equal to each rank's; (c) ``pretrain_mae`` under
     ``python -m torch.distributed.run --standalone --nproc_per_node 1`` for
     one epoch on phase 17's synthetic STL-10, in a one-rank group, writing
     its output layout.
  21. the bench's steady-state mode, ``Task.train_steps_fused`` (one eager
     step, the capture of the next in a CUDA graph, replays), at B=768
     through the bench's own tasks (``ssrl_vit_mae_jepa_torch/bench.py``):
     (a) for MAE, JEPA and the classifier's full fine-tune on auto, 5
     replayed steps equal 5 eager steps from a copy of the seeded state bit
     for bit under deterministic algorithms (params, Adam moments, count,
     rate, JEPA's EMA, the generator, the sums), and, with the default
     algorithms, within 2·5·lr per parameter (the JEPA gather's backward
     adds overlapping target rows with atomics); a graph of the draws alone
     gives replays 1 and 2 different masks, each the eager draw's; (b) one
     replay launches exactly one eager step's kernels, by name and count
     under ``torch.profiler``, and the two int64 fills that write the
     generator's seed and offset before it (copies counted as one kind; a
     replay adds nothing to the host launch counters, the capture adds one
     step's); (c) ms/step per-step and
     fused, each with its device ms/step, idle share and MFU, a
     ``{"fused_ms": ...}`` line; (d) MAE under packed, pallas, block, chain
     and ``SSRL_FUSED_EMBED=1`` checked as in (a); (e) ``python -m
     ssrl_vit_mae_jepa_torch.bench --task {mae,jepa,classifier} --fused``
     as processes, each last line with the bench's keys, ``platform``
     ``gpu`` and an MFU (MAE under ``--profile-dir``, with its device
     ms/step); (f) ``tests/fixtures/jax_native_classifier.ckpt``, a
     JAX-native checkpoint, read by ``load_any`` (no msgpack, flax or JAX
     here) and trained one step on the card; (g) in a one-rank ``nccl``
     group, MAE's fused steps (the all-reduces captured) against eager
     steps over the group as in (a).
  22. checkpoint fidelity at configs/mae.yaml's widths, on three
     reference-layout stand-ins made from a seed with numpy (a bare timm
     encoder, a Lightning MAE, a classifier): (a) ``parity_check`` on each
     as a process (the three at once), ``PARITY OK``, then ``check_file`` on
     the MAE and classifier files in this process with exactly 10 and 8
     launches of each f32 branch kernel (the encoder's 4 blocks, then the
     MAE's 4 + 2 or the classifier's 4); (b) the port's loaders patched to
     swap block 0's q and k rows: ``check_file`` on the classifier file
     prints ``PARITY FAILED``; (c) ``run_parity_protocol`` on the three
     with a synthetic STL-10 (texture, 800 test images): ``PROTOCOL OK``,
     Δ top-1 within 0.5 points; (d) ``convert_torch_checkpoint`` on each,
     read back by ``load_any`` equal bit for bit; (e) a ``Trainer`` on the
     card resumed from ``tests/fixtures/jax_native_classifier.ckpt``: params
     and Adam moments equal the file's after the relayout, count and rate
     equal, then one more epoch with exact launches of rows 1-5 and finite
     losses.

With arguments: ``--dp-worker DIR BACKEND timed|untimed`` is one rank of
phase 20 (b), and ``--fused-replay OUT`` is phase 21 in a fresh process
(the profiler of a process that ran phases 3-20 records some kernels in
the wrong session), both started by the script itself; ``--dp-cards N`` on a host with
N cards builds the kernels, runs phase 20 (b) with one process per card over
``nccl`` (then each rank's ms/step at B=768 a rank beside one card's) and
(c) with N processes, and prints a ``{"dp_cards": ...}`` line before the
last.

Each main-path run (phases 4, 6-9, 11-15, 17-22) zeroes every launch count
just before it and reads them just after. ``mha_stacked`` and ``mha_packed`` lie
on none of these paths (the JAX package reaches them from the JEPA
predictor's sub-layer route and by direct calls); phase 3b drives them.

The line before the last is ``{"kernels": [...]}`` (23 entries): per
kernel, ``ms``, ``plain_ms`` and ``bound_ms`` are per training step of
``step`` (the MAE step where it runs the kernel, else the JEPA step),
``*_jepa`` the same per JEPA step, ``*_classifier`` per full fine-tune
step of the classifier, ``*_<geometry>`` per call (``*_cls`` the
classifier's geometry); for the f32 forwards per ``extract_features``
batch of 256 (``step`` "features"), ``*_reconstruction`` per
``reconstruct_batch`` of 8, and their bound is the f32 CUDA-core rate. ``ms`` and
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
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import torch.nn.functional as F

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch import bench
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
from ssrl_vit_mae_jepa_torch.data.loaders import (
    get_pretrain_dataloaders,
    get_test_dataloader,
    get_train_dataloaders,
)
from ssrl_vit_mae_jepa_torch.data.pipeline import HostLoader, device_prefetch
from ssrl_vit_mae_jepa_torch.data.stl10 import write_synthetic_stl10
from ssrl_vit_mae_jepa_torch.parallel.mesh import broadcast_from, get_data_axis
from ssrl_vit_mae_jepa_torch.parallel.multihost import maybe_initialize_distributed
from ssrl_vit_mae_jepa_torch.runtime.native import native_available
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask
from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
from ssrl_vit_mae_jepa_torch.utils.flops import task_flops_per_image
from ssrl_vit_mae_jepa_torch.utils.load import (
    classifier_params_from_checkpoint,
    encoder_params_from_checkpoint,
    load_any,
    merge_encoder,
)
from ssrl_vit_mae_jepa_torch.utils.profiling import device_us, kernel_times

REPO = pathlib.Path(__file__).resolve().parent
BATCH = 768
STEPS, WARMUP = 10, 3
# bench.py:81-86, the pretraining settings the JAX bench times
PRE_CFG = {
    "mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
    "total_epochs": 800, "warmup_epochs": 20, "batch_size": BATCH,
    "base_learning_rate": 1.5e-4, "weight_decay": 0.05, "augment": True,
}
# name -> (L, D, H) of the transformer blocks; "cls" is the classifier's
# encoder over all 145 tokens, the JEPA target's shape with a backward
GEOMETRIES = {"enc": (37, 144, 6), "dec": (145, 192, 6), "ctx": (45, 144, 6),
              "pred": (145, 96, 6), "tgt": (145, 144, 6), "cls": (145, 144, 6)}
# blocks per training step at each geometry, by main path; the JEPA target
# encoder ("tgt") runs under no-grad, so only forward kernels; the
# classifier's full fine-tune runs its 4 blocks at "cls"
STEP_CALLS = {"mae": {"enc": 4, "dec": 2}, "jepa": {"ctx": 4, "pred": 2, "tgt": 4},
              "classifier": {"cls": 4}}
_TPU = "ssrl_vit_mae_jepa_tpu/ops/"
# branch kernel -> (source, TPU kernel, geometries it runs at)
_GRAD_GEOS = ("enc", "dec", "ctx", "pred", "cls")
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
CHAIN_DEPTH = {"enc": 4, "dec": 2, "ctx": 4, "pred": 2, "tgt": 4, "cls": 4}
CHAIN_CALLS = {"mae": {"enc": 1, "dec": 1}, "jepa": {"ctx": 1, "pred": 1, "tgt": 1},
               "classifier": {"cls": 1}}
# the classifier stage's freeze policies, policy -> (freeze_encoder,
# unfreeze_last_layers), and the launches of a step on the flagship encoder
# (4 blocks at (145, 144)) under each, and of an eval step
FREEZE = {"full": (False, None), "probe": (True, None), "unfreeze2": (False, 2)}
CLS_LAUNCHES = {
    "full": {"attn_branch_fwd": 4, "attn_branch_bwd": 4, "mlp_branch_fwd": 4,
             "mlp_branch_bwd": 4},
    "probe": {"attn_branch_fwd_nograd": 4, "mlp_branch_fwd": 4},
    "unfreeze2": {"attn_branch_fwd": 2, "attn_branch_fwd_nograd": 2, "attn_branch_bwd": 2,
                  "mlp_branch_fwd": 4, "mlp_branch_bwd": 2},
    "eval": {"attn_branch_fwd_nograd": 4, "mlp_branch_fwd": 4},
}
# the attention entry each forced impl's main path must launch
IMPL_ENTRY = {"packed": "mha_stacked_qkv", "pallas": "mha_pallas"}
# the f32 forwards of csrc/branch_f32.cu (phase 3f): geometry -> (B, L, D, H);
# "feat" is the feature extractor's and k-NN's encoder at batch 256 (the
# default of extract_features), "rec_enc" / "rec_dec" the reconstruction's
# MAE encoder (37 kept tokens) and decoder at --num_images 8
F32_GEOMETRIES = {"feat": (256, 145, 144, 6), "rec_enc": (8, 37, 144, 6),
                  "rec_dec": (8, 145, 192, 6)}
# calls of each f32 kernel per extract_features batch (4 encoder blocks) and
# per reconstruct_batch call (4 encoder and 2 decoder blocks)
F32_CALLS = {"features": {"feat": 4}, "reconstruction": {"rec_enc": 4, "rec_dec": 2}}
F32_KERNELS = {"attn_branch_fwd_nograd_f32": ("attn", _TPU + "block_pallas.py:692"),
               "mlp_branch_fwd_f32": ("mlp", _TPU + "block_pallas.py:807")}
# the f32 forwards against their plain versions (TF32 off), unit-scale
# inputs: the f32 forward tolerance of tests/test_block_kernel.py
F32_ATOL = 5e-5
# the card's peaks (NVIDIA's H100 SXM data sheet): dense bf16 tensor-core
# rate and device-memory rate; and the f32 rate outside the tensor cores,
# which bounds the f32 forwards (no TF32 in their contract)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_ATOL = 6e-2       # bf16 forward tolerance of tests/test_block_kernel.py
# backward: both sides round to bf16 at different points (the plain version's
# autograd rounds dW, dP and dy1 to bf16; the kernel keeps them in f32), so
# each output is held to 2% of its largest magnitude -- far below the O(1)
# relative error of a layout or indexing fault
BWD_REL = 2e-2
LOSS_RTOL = 2e-2      # bf16 step, kernels on the card vs plain on the CPU
# a bf16 step's parameter gradients, card vs CPU: each within 10% of the CPU
# tensor's largest magnitude (tests/test_torch_classifier.py's bf16 bound
# against the JAX step); a wrong backward is off by O(1) of it
STEP_GRAD_REL = 1e-1


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


# a profiler session now and then records no device activity, up to three
# in a row in one call; after this many such sessions device_ms falls back
# to CUDA events
PROFILER_SESSIONS = 6


def device_ms(fn, iters: int = 10, by_kernel: dict | None = None) -> float:
    """Device time of one call of ``fn``: the summed durations of the device
    kernels it launches, under ``torch.profiler``, over ``iters`` calls after
    a warm-up call; ``by_kernel`` gets each kernel's share. Where no session
    of PROFILER_SESSIONS records device time, the CUDA-event time of the
    calls (``cuda_ms``), which also holds the gaps between the kernels, and
    ``by_kernel`` stays empty."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        shares = {e.key: device_us(e) / 1e3 / iters for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
        if sum(shares.values()) > 0:
            if by_kernel is not None:
                by_kernel.update(shares)
            return sum(shares.values())
        print("  (torch.profiler recorded no device time; profiling again)", flush=True)
        time.sleep(0.1)
    print(f"  (no device time in {PROFILER_SESSIONS} profiler sessions: CUDA events instead)",
          flush=True)
    return cuda_ms(fn, iters)


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
    step of the first main path of ``calls_by_step`` that runs it (MAE, then
    JEPA, then the classifier's full fine-tune; for the f32 forwards the
    feature extractor's batch, then the reconstruction's), a later path's
    per step under ``*_<path>``, every geometry's per call under ``*_<geo>``."""
    runs = [s for s, calls in calls_by_step.items() if any(g in per_geo for g in calls)]
    keys = [k for k in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                        "library_device_ms")
            if all(k in v for v in per_geo.values())]
    worst = max(per_geo.values(), key=lambda v: v["bound_ms"])
    r = {"max_abs_err": err, "bound_by": worst["bound_by"], "step": runs[0]}
    for k in keys:
        r[k] = per_step(per_geo, k, calls_by_step[runs[0]])
        for later in runs[1:]:
            r[f"{k}_{later}"] = per_step(per_geo, k, calls_by_step[later])
        r.update({f"{k}_{g}": v[k] for g, v in per_geo.items()})
    return r


def branch_inputs(kind: str, L: int, D: int, seed: int, batch: int = BATCH):
    """bf16 activations and f32 params at realistic scales, on the card."""
    g = torch.Generator().manual_seed(seed)
    n = 3 * D if kind == "attn" else 4 * D
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    wb_in = D if kind == "attn" else n
    params = [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(n, D) * D**-0.5, 0.1 * rn(n),
              rn(D, wb_in) * wb_in**-0.5, 0.1 * rn(D)]
    x = rn(batch, L, D).to(torch.bfloat16)
    dy = rn(batch, L, D).to(torch.bfloat16)
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


def f32_bound(kind: str, B: int, L: int, D: int):
    """Least time of one f32 forward at (B, L, D), F = 4D: x read and the
    output written once, the f32 weights read once; the products (qkv 6,
    proj 2, or fc1 8 and fc2 8, x MD^2) and attention's 4BL^2D at the f32
    CUDA-core peak."""
    M = B * L
    if kind == "attn":
        w, flops = 4 * D * D + 6 * D, 8 * M * D * D + 4 * B * L * L * D
    else:
        w, flops = 8 * D * D + 7 * D, 16 * M * D * D
    tb = (2 * M * D + w) * 4 / PEAK_BYTES * 1e3
    to = flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_f32() -> dict:
    """Phase 3f: the f32 forwards of ``csrc/branch_f32.cu`` against their
    plain versions (``attn_branch_ref`` / ``mlp_branch_ref`` at f32) on the
    card with TF32 off, at F32_GEOMETRIES, with per-call times and bounds."""
    per = {k: {} for k in F32_KERNELS}
    errs = dict.fromkeys(F32_KERNELS, 0.0)
    for geo, (B, L, D, H) in F32_GEOMETRIES.items():
        for name, (kind, _) in F32_KERNELS.items():
            x, _, params = branch_inputs(kind, L, D, seed=B + L + D, batch=B)
            x = x.float()
            extra = (H,) if kind == "attn" else ()
            kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
            ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref
            with torch.no_grad():
                out = kern(x, *params, *extra)
                want = ref(x, *params, *extra)
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                if not (out.dtype == torch.float32 and err <= F32_ATOL):
                    fail(f"{name}@{geo}: {out.dtype}, max abs err {err} > {F32_ATOL}")
                t_k = cuda_ms(lambda: kern(x, *params, *extra))
                t_p = cuda_ms(lambda: ref(x, *params, *extra))
            b_ms, b_by = f32_bound(kind, B, L, D)
            per[name][geo] = {"ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by}
            errs[name] = max(errs[name], err)
            print(f"  {name}@{geo} B={B} L={L} D={D}: {t_k:.3f} ms (plain {t_p:.3f}, bound "
                  f"{b_ms:.3f} by {b_by}); max abs err {err:.3e}", flush=True)
            del x, out, want
    return {k: summarize(per[k], errs[k], F32_CALLS) for k in F32_KERNELS}


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
    per_step = dict.fromkeys(STEP_CALLS, 0.0)
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
            if not shares or k_ms <= 0 or m_ms <= 0:
                # the profiler fell back, or its session missed one side's
                # kernels: each side by CUDA events
                k_ms, red_ms = cuda_ms(lambda: bf.gemm(a, b, layout, epi, **ex)), 0.0
                m_ms = cuda_ms(lambda: torch.matmul(at, bt))
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
          f"JEPA {per_step['jepa']:.3f}, classifier full fine-tune {per_step['classifier']:.3f}",
          flush=True)
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


def flagship_images(seed: int = 0, n: int = BATCH, device="cuda"):
    """uint8 images, STL-10 labels and unit weights from a seed."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return {"image": torch.from_numpy(images).to(device),
            "label": torch.from_numpy(labels).to(device),
            "weight": torch.ones(n, device=device)}


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
    return state, sums, launches, ms


def check_moved(before: dict, after: dict, what: str) -> None:
    moved = sum(int(not torch.equal(before[k], v)) for k, v in after.items())
    if moved != len(before):
        fail(f"{what}: only {moved} of {len(before)} tensors changed")


def mae_step(model_cfg: dict, name: str, impl: str, fused: bool = False,
             pre_cfg: dict = PRE_CFG, route: str = ""):
    """Phases 4, 6, 7, 9, 11, 12, 19: the flagship step through MAETask on
    the card (``route`` names a lineage route of phase 19); returns its
    launches and ms/step."""
    with fused_embed(fused):
        task = MAETask(model_cfg, pre_cfg, dtype=torch.bfloat16, device="cuda", attn_impl=impl)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        what = (f"MAE step attn_impl={impl}" + (" SSRL_FUSED_EMBED=1" if fused else "")
                + (f" {route}" if route else ""))
        state, _, launches, ms = timed_steps(task, state, flagship_images(), name, what)
    check_moved(before, state.params, what)
    want = expected(mae_launches(impl, fused), STEPS)
    if launches != want:
        fail(f"{what}: launches in {STEPS} steps {launches}, expected {want}")
    del task, state
    torch.cuda.empty_cache()
    return launches, ms


def on_cpu(draws: tuple) -> tuple:
    """The draws on the CPU (None, the augmentation's when it is off, stays)."""
    return tuple(None if d is None else d.cpu() for d in draws)


def check_step_grads(what: str, gpu, gs, gbatch: dict, cpu, cs, cbatch: dict, draws: tuple,
                     ctx=None) -> None:
    """One step's trainable gradients, kernels on the card against the plain
    path on the CPU from the same weights and draws, before the step updates
    the params: each within STEP_GRAD_REL of the CPU tensor's largest
    magnitude."""
    names, g_gpu, _ = gpu.gradients(gs, gbatch, ctx, draws)
    names_cpu, g_cpu, _ = cpu.gradients(cs, cbatch, ctx, on_cpu(draws))
    if names != names_cpu:
        fail(f"{what}: the card trains {len(names)} tensors, the CPU {len(names_cpu)}")
    worst, worst_name = 0.0, ""
    for k, a, b in zip(names, g_gpu, g_cpu):
        err = (a.float().cpu() - b.float()).abs().max().item()
        lim = STEP_GRAD_REL * b.float().abs().max().item() + 1e-6
        if err / lim > worst:
            worst, worst_name = err / lim, k
        if not err <= lim:
            fail(f"{what} gradient {k}: card vs CPU max abs err {err:.3e} > {lim:.3e}")
    print(f"  {what}: {len(names)} trainable gradients, card vs CPU, the worst at "
          f"{worst:.3f} of its bound ({worst_name}; bound {STEP_GRAD_REL:g} of each CPU "
          f"tensor's largest magnitude)")


def cpu_agreement(model_cfg: dict, impl: str, pre_cfg: dict = PRE_CFG, route: str = "") -> None:
    """Phases 5-7, 11, 12, 19: B=16, same weights and draws, kernels vs plain
    CPU path."""
    n = 16
    gpu = MAETask(model_cfg, pre_cfg, dtype=torch.bfloat16, device="cuda", attn_impl=impl)
    cpu = MAETask(model_cfg, pre_cfg, dtype=torch.bfloat16, device="cpu", attn_impl=impl)
    gs, cs = gpu.init_state(1), cpu.init_state(1)
    cpu.model.load_state_dict(gpu.model.state_dict())
    images = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)
    )
    ctx = gpu.epoch_context(0)
    draws = gpu.draw(gs.generator, n, ctx)
    weight = torch.ones(n)
    check_step_grads(f"attn_impl={impl} {route} B={n}", gpu, gs,
                     {"image": images.cuda(), "weight": weight.cuda()},
                     cpu, cs, {"image": images, "weight": weight}, draws, ctx)
    reset_counts()
    _, s_gpu = gpu.train_step(gs, {"image": images.cuda(), "weight": weight.cuda()},
                              0, ctx, draws)
    launched = launch_counts()
    _, s_cpu = cpu.train_step(cs, {"image": images, "weight": weight}, 0, ctx,
                              on_cpu(draws))
    if launch_counts() != launched or launched != expected(mae_launches(impl)):
        fail(f"launch counts: {launch_counts()} (the GPU step must launch one of each "
             f"kernel of attn_impl={impl} per block, the CPU step none)")
    lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
    print(f"  attn_impl={impl} {route} B={n} loss: kernels on the card {lg:.6f}, "
          f"plain on the CPU {lc:.6f}")
    if not abs(lg - lc) <= LOSS_RTOL * abs(lc):
        fail(f"loss disagrees: {lg} vs {lc} (rtol {LOSS_RTOL})")


def jepa_step(model_cfg: dict, jepa_cfg: dict, name: str, fused: bool,
              impl: str = "auto", route: str = ""):
    """Phases 8, 9, 13, 14, 19: the flagship JEPA step through JEPATask on
    the card; returns its launches and ms/step."""
    what = (f"JEPA step attn_impl={impl}" + (" SSRL_FUSED_EMBED=1" if fused else "")
            + (f" {route}" if route else ""))
    with fused_embed(fused):
        task = JEPATask(model_cfg, jepa_cfg, dtype=torch.bfloat16, device="cuda",
                        attn_impl=impl)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        extra0 = {k: v.clone() for k, v in state.extra.items()}
        state, sums, launches, ms = timed_steps(task, state, flagship_images(), name, what)
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
    return launches, ms


def jepa_cpu_agreement(model_cfg: dict, jepa_cfg: dict, impl: str = "auto",
                       route: str = "") -> None:
    """Phases 10, 13, 14, 19: B=16, same weights, EMA and draws, kernels vs
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
    check_step_grads(f"JEPA attn_impl={impl} {route} B={n}", gpu, gs,
                     {"image": images.cuda(), "weight": weight.cuda()},
                     cpu, cs, {"image": images, "weight": weight}, draws)
    reset_counts()
    _, s_gpu = gpu.train_step(gs, {"image": images.cuda(), "weight": weight.cuda()},
                              0, None, draws)
    launched = launch_counts()
    _, s_cpu = cpu.train_step(cs, {"image": images, "weight": weight}, 0, None,
                              on_cpu(draws))
    if launch_counts() != launched or launched != expected(jepa_launches(False, impl)):
        fail(f"launch counts: {launch_counts()} (the GPU JEPA step must launch "
             f"{jepa_launches(False, impl)}, the CPU step nothing)")
    lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
    print(f"  JEPA attn_impl={impl} {route} B={n} loss: kernels on the card {lg:.6f}, "
          f"plain on the CPU {lc:.6f}")
    if not abs(lg - lc) <= LOSS_RTOL * abs(lc):
        fail(f"JEPA loss disagrees: {lg} vs {lc} (rtol {LOSS_RTOL})")


def classifier_task(model_cfg: dict, train_cfg: dict, policy: str, device: str,
                    impl: str = "auto", augment: bool = True):
    """``ClassifierTask`` on the configuration's train section, bf16, under
    one freeze policy of ``FREEZE``."""
    task = ClassifierTask(model_cfg, train_cfg, dtype=torch.bfloat16, device=device,
                          attn_impl=impl, augment=augment)
    freeze_encoder, unfreeze = FREEZE[policy]
    task.set_freeze_policy(freeze_encoder=freeze_encoder, unfreeze_last_layers=unfreeze)
    return task


def check_frozen(task, before: dict, after: dict, what: str) -> None:
    """Every trainable tensor moved, every frozen one kept its bits."""
    trainable = set(task.tx.trainable(after))
    moved = {k for k, v in after.items() if not torch.equal(before[k], v.detach().to(before[k].device))}
    if moved != trainable:
        fail(f"{what}: moved {len(moved)} tensors, {len(trainable)} trainable; frozen that "
             f"moved: {sorted(moved - trainable)[:4]}, trainable that did not: "
             f"{sorted(trainable - moved)[:4]}")
    print(f"  {what}: {len(trainable)} of {len(after)} tensors trainable, all moved; "
          f"the other {len(after) - len(trainable)} bit-identical")


def classifier_steps(model_cfg: dict, train_cfg: dict, name: str, policies=tuple(FREEZE),
                     augment: bool = True):
    """Phases 15 and 19: the flagship classifier step through
    ``ClassifierTask`` under each of ``policies``, then (augmentation on)
    its eval step; exact launches per step. Returns the launches and the
    ms/step of each policy."""
    launches = dict.fromkeys(launch_counts(), 0)
    step_ms = {}
    batch = flagship_images()
    for policy in policies:
        task = classifier_task(model_cfg, train_cfg, policy, "cuda", augment=augment)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        what = f"classifier step {policy}" + ("" if augment else " augment off")
        state, sums, got, step_ms[policy] = timed_steps(task, state, batch, name, what)
        check_frozen(task, before, state.params, what)
        want = expected(CLS_LAUNCHES[policy], STEPS)
        if got != want:
            fail(f"{what}: launches in {STEPS} steps {got}, expected {want}")
        metrics = task.epoch_metrics_from_sums({k: float(v) for k, v in sums[-1].items()},
                                               "train")
        print(f"  last step: {metrics}")
        for k, v in got.items():
            launches[k] += v
        if policy == "full" and augment:
            gen = torch.Generator("cuda").manual_seed(0)
            for _ in range(WARMUP):
                task.eval_step(state, batch, gen)
            torch.cuda.synchronize()
            reset_counts()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(STEPS):
                s = task.eval_step(state, batch, gen)
            end.record()
            torch.cuda.synchronize()
            got = launch_counts()
            ms = start.elapsed_time(end) / STEPS
            m = task.epoch_metrics_from_sums({k: float(v) for k, v in s.items()}, "val")
            print(f"  classifier eval step B={BATCH} bf16 on {name}: {ms:.3f} ms/step "
                  f"(CUDA events), {BATCH / ms * 1e3:.1f} img/s; {m}", flush=True)
            if got != expected(CLS_LAUNCHES["eval"], STEPS):
                fail(f"classifier eval: launches in {STEPS} steps {got}, expected "
                     f"{expected(CLS_LAUNCHES['eval'], STEPS)}")
            if not all(math.isfinite(v) for v in m.values()):
                fail(f"classifier eval: {m}")
            for k, v in got.items():
                launches[k] += v
        del task, state
        torch.cuda.empty_cache()
    return launches, step_ms


def classifier_cpu_agreement(model_cfg: dict, train_cfg: dict, policies=tuple(FREEZE),
                             augment: bool = True) -> None:
    """Phases 16 and 19: B=16, same weights and draws, kernels on the card
    against the plain path on the CPU, under each of ``policies`` (the loss,
    every trainable gradient, the frozen tensors' bits); then (augmentation
    on) the eval step's sums."""
    n = 16
    for policy in policies:
        gpu = classifier_task(model_cfg, train_cfg, policy, "cuda", augment=augment)
        cpu = classifier_task(model_cfg, train_cfg, policy, "cpu", augment=augment)
        gs, cs = gpu.init_state(1), cpu.init_state(1)
        cpu.model.load_state_dict(gpu.model.state_dict())
        batch = flagship_images(1, n, "cpu")
        if policy == "full" and augment:
            reset_counts()
            eg = gpu.eval_step(gs, {k: v.cuda() for k, v in batch.items()}, None)
            launched = launch_counts()
            ec = cpu.eval_step(cs, batch, None)
            if launch_counts() != launched or launched != expected(CLS_LAUNCHES["eval"]):
                fail(f"classifier eval launch counts: {launch_counts()}")
            print(f"  eval B={n}: card {({k: round(float(v), 5) for k, v in eg.items()})}, "
                  f"CPU {({k: round(float(v), 5) for k, v in ec.items()})}")
            if not abs(float(eg["acc_sum"]) - float(ec["acc_sum"])) <= 1.0:
                fail(f"eval acc_sum disagrees: {float(eg['acc_sum'])} vs {float(ec['acc_sum'])}")
            lg, lc = float(eg["loss_sum"]), float(ec["loss_sum"])
            if not abs(lg - lc) <= LOSS_RTOL * abs(lc):
                fail(f"eval loss_sum disagrees: {lg} vs {lc} (rtol {LOSS_RTOL})")
        draws = gpu.draw(gs.generator, n, None)
        before = {k: v.detach().clone() for k, v in cs.params.items()}
        check_step_grads(f"classifier {policy}", gpu, gs, {k: v.cuda() for k, v in batch.items()},
                         cpu, cs, batch, draws)
        reset_counts()
        _, s_gpu = gpu.train_step(gs, {k: v.cuda() for k, v in batch.items()}, 0, None, draws)
        launched = launch_counts()
        _, s_cpu = cpu.train_step(cs, batch, 0, None, on_cpu(draws))
        if launch_counts() != launched or launched != expected(CLS_LAUNCHES[policy]):
            fail(f"classifier {policy} launch counts: {launch_counts()}, expected "
                 f"{CLS_LAUNCHES[policy]} on the card and nothing on the CPU")
        lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
        print(f"  classifier {policy} B={n} loss: kernels on the card {lg:.6f}, plain on "
              f"the CPU {lc:.6f}")
        if not abs(lg - lc) <= LOSS_RTOL * abs(lc):
            fail(f"classifier {policy} loss disagrees: {lg} vs {lc} (rtol {LOSS_RTOL})")
        check_frozen(cpu, before, cs.params, f"classifier {policy} on the CPU")
        check_frozen(gpu, before, gs.params, f"classifier {policy} on the card")


def loader_rate(loader, epochs: int = 3) -> float:
    """Sustained img/s (real examples) of the host loader through
    ``device_prefetch`` to the card, with no step consuming the batches."""
    t0 = time.perf_counter()
    for e in range(epochs):
        for _ in device_prefetch(loader.epoch(e), "cuda", depth=loader.prefetch_depth):
            pass
    torch.cuda.synchronize()
    return epochs * loader.num_examples / (time.perf_counter() - t0)


def stage_end_to_end(cfg: dict, mae_ms: float) -> dict:
    """Phase 17: the stage through the port's entry points on a synthetic
    STL-10 (texture signal): MAE ``Trainer.fit`` for 2 epochs at B=768, the
    encoder of its ``best.ckpt`` merged into a classifier, ``Trainer.fit``
    of the full fine-tune for 2 epochs at B=256 and ``Trainer.test``, and
    a resume from ``last.ckpt``; exact launches of the whole phase."""
    import copy
    import tempfile

    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        write_synthetic_stl10(tmp / "data", num_train=1000, num_test=800, num_unlabeled=4000,
                              seed=0, class_signal="texture")
        print(f"  synthetic STL-10 (1000 train, 800 test, 4000 unlabeled, texture) written "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        c = copy.deepcopy(cfg)
        c["pretrain"]["batch_size"] = BATCH
        c["train"].update(samples_per_class=80, batch_size=256)
        c["test"]["batch_size"] = 256
        mtrain, mval = get_pretrain_dataloaders(c, tmp / "data")
        native = native_available()  # builds the host gather before it is timed
        for b in (BATCH, 2000):
            ld = HostLoader(mtrain.dataset, mtrain.indices, b, shuffle=True)
            ld.prefetch_depth = mtrain.prefetch_depth
            rate = loader_rate(ld)
            print(f"  host loader B={b}: {rate:.1f} img/s sustained to the card (depth "
                  f"{ld.prefetch_depth}, native gather {native}); the MAE step "
                  f"(phase 4) takes {BATCH / mae_ms * 1e3:.1f} img/s", flush=True)
        reset_counts()
        mae = Trainer(MAETask(c["model"], c["pretrain"], device="cuda"), 2, tmp / "mae",
                      hyper_parameters=c)
        m = mae.fit(mtrain, mval)
        ckpts = tmp / "mae" / "checkpoints"
        for f in (ckpts / "best.ckpt", ckpts / "last.ckpt", tmp / "mae" / "metrics.jsonl"):
            if not f.is_file():
                fail(f"MAE fit wrote no {f.name}")
        lines = [json.loads(x) for x in (tmp / "mae" / "metrics.jsonl").read_text().split("\n") if x]
        if len(lines) != 2 or not all(math.isfinite(x["train_loss"]) and math.isfinite(x["val_loss"])
                                      for x in lines):
            fail(f"MAE metrics.jsonl: {lines}")
        enc, report = encoder_params_from_checkpoint(ckpts / "best.ckpt",
                                                     c["model"]["encoder"]["depth"])
        if report["missing"]:
            fail(f"encoder of best.ckpt: {report}")
        ctrain, cval = get_train_dataloaders(c, tmp / "data")
        test = get_test_dataloader(c, tmp / "data")
        cls = Trainer(ClassifierTask(c["model"], c["train"], device="cuda"), 2, tmp / "cls",
                      hyper_parameters=c)
        cm = cls.fit(ctrain, cval, init_params_override=lambda p: merge_encoder(p, enc))
        tm = cls.test(test)
        print(f"  test: {tm}", flush=True)
        if not (0.0 <= tm["test_acc"] <= 1.0 and math.isfinite(tm["test_loss"])
                and all(math.isfinite(cm[k]) for k in ("train_loss", "val_loss"))):
            fail(f"classifier stage: fit {cm}, test {tm}")
        resumed = Trainer(ClassifierTask(c["model"], c["train"], device="cuda"), 3,
                          tmp / "cls_resumed")
        resumed.fit(ctrain, cval, resume_from=tmp / "cls" / "checkpoints" / "last.ckpt")
        lines = [json.loads(x) for x in
                 (tmp / "cls_resumed" / "metrics.jsonl").read_text().split("\n") if x]
        if [x["epoch"] for x in lines] != [2] or resumed.global_step != 3 * len(ctrain):
            fail(f"resume: epochs {[x['epoch'] for x in lines]}, global step "
                 f"{resumed.global_step} (expected [2] and {3 * len(ctrain)})")
        got = launch_counts()
    # MAE: 6 blocks a step (4 encoder, 2 decoder), forward and backward, and
    # 6 no-grad forwards a val batch; classifier: 4 blocks a step, 4 no-grad
    # forwards an eval batch (val each epoch, test once)
    mae_steps, mae_evals = 2 * len(mtrain), 2 * len(mval)
    cls_steps = 3 * len(ctrain)
    cls_evals = 3 * len(cval) + len(test)
    grad = 6 * mae_steps + 4 * cls_steps
    nograd = 6 * mae_evals + 4 * cls_evals
    want = expected({"attn_branch_fwd": grad, "attn_branch_bwd": grad,
                     "mlp_branch_fwd": grad + nograd, "mlp_branch_bwd": grad,
                     "attn_branch_fwd_nograd": nograd})
    if got != want:
        fail(f"stage launches {got}, expected {want}")
    print(f"  launches of the stage: {got}", flush=True)
    return got


# phase 18: the port's CLIs at configs/mae.yaml's widths on a synthetic
# STL-10 (texture signal, phase 17's sizes), cut in epochs and data only
CLI = "ssrl_vit_mae_jepa_torch.scripts"
CLI_DATA = (1000, 800, 4000)  # train, test, unlabeled images
CLI_LABELS = 80  # labeled images per class the classifier CLIs train on
# what every training CLI writes into its run directory
CLI_FILES = ("config.yaml", "metrics.jsonl", "checkpoints/best.ckpt", "checkpoints/last.ckpt")
# extract_features and reconstruct_batch on the card against the same
# functions on the CPU, both f32 (TF32 off), so they differ by summation
# order only: features of O(1) are held to 5e-5 (the f32 tolerance of one
# kernel, phase 3f) and images in [0, 1] and the masked-patch metrics to
# 1e-5. A TF32-grade error (~1e-3 relative per GEMM) fails both.
F32_FEATURE_ATOL, F32_IMAGE_ATOL = 5e-5, 1e-5


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables set (None: unset) inside the block."""
    def put(items):
        for k, v in items.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    old = {k: os.environ.get(k) for k in values}
    put(values)
    try:
        yield
    finally:
        put(old)


def start_cli(module: str, *args, cwd=REPO, env=None) -> tuple:
    """``python -m ssrl_vit_mae_jepa_torch.scripts.<module>`` started in a
    process of its own, on its default device (``SSRL_TORCH_DEVICE`` unset:
    the card), and not waited for: (process, start time, module)."""
    full = {k: v for k, v in os.environ.items() if k != "SSRL_TORCH_DEVICE"}
    full.update(env or {})
    proc = subprocess.Popen([sys.executable, "-m", f"{CLI}.{module}", *map(str, args)],
                            cwd=cwd, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, time.perf_counter(), module


def finish_cli(started: tuple) -> str:
    """Wait for a process of ``start_cli`` (killed after 600 s); fails the
    smoke test on a nonzero exit; returns its stdout."""
    proc, t0, module = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    print(f"  python -m {CLI}.{module}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        fail(f"{module} exited {proc.returncode}\n{out[-3000:]}\n{err[-3000:]}")
    return out


def run_cli(module: str, *args, cwd=REPO, env=None) -> str:
    """``start_cli`` then ``finish_cli``: the CLI's stdout."""
    return finish_cli(start_cli(module, *args, cwd=cwd, env=env))


def check_files(run: pathlib.Path, names) -> None:
    missing = [n for n in names if not (run / n).is_file()]
    if missing:
        fail(f"{run.name}: no {missing}")


def cli_end_to_end(cfg: dict) -> dict:
    """Phase 18: the CLIs on the card. As processes of their own: the data
    CLI, pretrain_mae (B=768, 2 epochs), train_mae from its best.ckpt (B=256,
    2 epochs), evaluate_classifier, pretrain_jepa (B=768, 1 epoch), and one
    cell of each ablation driver; in this process, with exact launches:
    train_mae from vit-jepa.pt, knn_eval, and extract_features and
    reconstruct_batch (the f32 kernels only), each held to the same function
    on the CPU. Returns the launches of the in-process runs."""
    import copy
    import re
    import tempfile

    import yaml

    from ssrl_vit_mae_jepa_torch.data.stl10 import STL10
    from ssrl_vit_mae_jepa_torch.ops.masking import num_masked_tokens, random_token_mask
    from ssrl_vit_mae_jepa_torch.scripts.evaluation import knn_eval
    from ssrl_vit_mae_jepa_torch.scripts.evaluation import visualize_reconstruction as vrec
    from ssrl_vit_mae_jepa_torch.scripts.evaluation import visualize_representation as vrep
    from ssrl_vit_mae_jepa_torch.scripts.training import train_mae

    total = dict.fromkeys(launch_counts(), 0)
    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = pathlib.Path(tmp)
        data, out = tmp / "data", tmp / "outputs"
        env = {"SSRL_DATA_DIR": str(data)}
        n_train, n_test, n_unl = CLI_DATA
        run_cli("data", "--synthetic", "--signal", "texture", "--data_dir", data,
                "--synthetic_train", n_train, "--synthetic_test", n_test,
                "--synthetic_unlabeled", n_unl)
        c = copy.deepcopy(cfg)
        c["pretrain"].update(batch_size=BATCH, total_epochs=2, warmup_epochs=1)
        c["jepa"].update(batch_size=BATCH, total_epochs=1, warmup_epochs=1)
        c["train"].update(samples_per_class=CLI_LABELS, batch_size=256, total_epochs=2,
                          warmup_epochs=1)
        c["test"]["batch_size"] = 256
        c["logging"].update(output_dir_base=str(out), log_every_n_steps=2)
        cfg_path = tmp / "cli.yaml"
        cfg_path.write_text(yaml.safe_dump(c))

        run_cli("training.pretrain_mae", "--config", cfg_path, "--output_dir_suffix", "mae",
                env=env)
        pre = out / "pretrain" / "mae"
        check_files(pre, CLI_FILES + ("vit-mae.pt",))
        run_cli("training.train_mae", "--config", cfg_path, "--encoder_ckpt",
                pre / "checkpoints" / "best.ckpt", "--output_dir_suffix", "mae_probe", env=env)
        probe = out / "train" / "mae_probe"
        check_files(probe, CLI_FILES + ("vit-mae.pt",))
        stdout = run_cli("evaluation.evaluate_classifier", "--config", cfg_path, "--checkpoint",
                         probe / "checkpoints" / "best.ckpt", env=env)
        m = re.search(r"Test Accuracy: ([0-9.eE+-]+)", stdout)
        acc = float(m.group(1)) if m else float("nan")
        print(f"  evaluate_classifier: test_acc {acc}", flush=True)
        if not 0.0 <= acc <= 1.0:
            fail(f"evaluate_classifier: test_acc {acc}\n{stdout[-2000:]}")
        check_files(out / "test" / "default", ("metrics.jsonl",))
        run_cli("training.pretrain_jepa", "--config", cfg_path, "--output_dir_suffix", "jepa",
                env=env)
        jepa = out / "pretrain" / "jepa"
        check_files(jepa, CLI_FILES + ("vit-jepa.pt", "jepa_state.ckpt"))
        steps = [json.loads(x) for x in (pre / "metrics.jsonl").read_text().split("\n") if x]
        print(f"  pretrain_mae metrics.jsonl: {len(steps)} records "
              f"({sum('val_loss' in r for r in steps)} epochs)", flush=True)

        with env_vars(SSRL_DATA_DIR=str(data), SSRL_TORCH_DEVICE=None):
            ctrain, cval = get_train_dataloaders(c, data)
            reset_counts()
            t0 = time.perf_counter()
            train_mae.main(["--config", str(cfg_path), "--encoder_ckpt",
                            str(jepa / "vit-jepa.pt"), "--output_dir_suffix", "jepa_probe"])
            got = launch_counts()
            # configs/mae.yaml fine-tunes the whole model: 4 blocks a step
            # forward and backward, 4 no-grad forwards an eval batch
            n_steps, n_evals = 2 * len(ctrain), 2 * len(cval)
            want = expected({"attn_branch_fwd": 4 * n_steps, "attn_branch_bwd": 4 * n_steps,
                             "mlp_branch_fwd": 4 * (n_steps + n_evals),
                             "mlp_branch_bwd": 4 * n_steps,
                             "attn_branch_fwd_nograd": 4 * n_evals})
            print(f"  train_mae --encoder_ckpt vit-jepa.pt in process: "
                  f"{time.perf_counter() - t0:.1f} s, launches {got}", flush=True)
            if got != want:
                fail(f"train_mae from vit-jepa.pt: launches {got}, expected {want}")
            for k, v in got.items():
                total[k] += v

            # the f32 entry points: per encoder batch 4 blocks, per
            # reconstruction 4 encoder and 2 decoder blocks, f32 kernels only
            f32 = list(F32_KERNELS)
            best = pre / "checkpoints" / "best.ckpt"
            reset_counts()
            t0 = time.perf_counter()
            knn_acc = knn_eval.main(["--config", str(cfg_path), "--checkpoint", str(best),
                                     "--batch_size", "256", "--eval", "both"])
            got = launch_counts()
            batches = -(-n_train // 256) + -(-n_test // 256)
            print(f"  knn_eval in process: {time.perf_counter() - t0:.1f} s, k-NN test acc "
                  f"{knn_acc}, launches {got}", flush=True)
            if got != expected(dict.fromkeys(f32, 4 * batches)):
                fail(f"knn_eval launches {got}, expected {4 * batches} of each f32 kernel")
            for k, v in got.items():
                total[k] += v

            reset_counts()
            t0 = time.perf_counter()
            feats, labels = vrep.extract_features(c, best, split="test", batch_size=256)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = launch_counts()
            n_batches = -(-n_test // 256)
            if got != expected(dict.fromkeys(f32, 4 * n_batches)):
                fail(f"extract_features launches {got}, expected {4 * n_batches} of each f32 "
                     "kernel and nothing else")
            for k, v in got.items():
                total[k] += v
            with env_vars(SSRL_TORCH_DEVICE="cpu"):
                feats_cpu, labels_cpu = vrep.extract_features(c, best, split="test",
                                                              batch_size=256)
            err = float(np.abs(feats - feats_cpu).max())
            print(f"  extract_features: {feats.shape} in {dt:.2f} s on the card "
                  f"({n_test / dt:.0f} img/s, host included), launches {got}; card vs CPU "
                  f"max abs err {err:.3e} (max |feature| {np.abs(feats_cpu).max():.3f})",
                  flush=True)
            width = c["model"]["encoder"]["embed_dim"]
            if not (feats.shape == (n_test, width) and np.array_equal(labels, labels_cpu)
                    and err <= F32_FEATURE_ATOL):
                fail(f"extract_features: card vs CPU max abs err {err} > {F32_FEATURE_ATOL}")

            images = STL10(data, "train").images_nhwc(np.arange(8))
            masks = random_token_mask(torch.Generator().manual_seed(vrec.MASK_SEED), 8, 145,
                                      num_masked_tokens(145, 0.75))
            reset_counts()
            rec = vrec.reconstruct_batch(c, pre / "vit-mae.pt", images, masks=masks)
            got = launch_counts()
            if got != expected(dict.fromkeys(f32, 6)):
                fail(f"reconstruct_batch launches {got}, expected 6 of each f32 kernel and "
                     "nothing else")
            for k, v in got.items():
                total[k] += v
            with env_vars(SSRL_TORCH_DEVICE="cpu"):
                rec_cpu = vrec.reconstruct_batch(c, pre / "vit-mae.pt", images, masks=masks)
            err = max(float(np.abs(rec[k] - rec_cpu[k]).max())
                      for k in ("original", "masked", "reconstructed"))
            merr = max(abs(rec[k] - rec_cpu[k]) / max(abs(rec_cpu[k]), 1e-12)
                       for k in ("mse", "mae", "psnr"))
            print(f"  reconstruct_batch: mse {rec['mse']:.5f} psnr {rec['psnr']:.3f} dB, "
                  f"launches {got}; card vs CPU images max abs err {err:.3e}, metrics max rel "
                  f"err {merr:.3e}", flush=True)
            if not (err <= F32_IMAGE_ATOL and merr <= F32_IMAGE_ATOL):
                fail(f"reconstruct_batch: card vs CPU {err}, {merr} > {F32_IMAGE_ATOL}")

        # one cell of each ablation driver, in a directory of its own (the
        # drivers write configs/ under the working directory)
        abl = tmp / "ablation"
        abl.mkdir()
        a = copy.deepcopy(c)
        a["pretrain"]["total_epochs"] = a["train"]["total_epochs"] = 1
        a["logging"]["output_dir_base"] = str(abl / "outputs")
        (abl / "base.yaml").write_text(yaml.safe_dump(a))
        aenv = {**env, "PYTHONPATH": str(REPO), "SSRL_ABLATION_CONFIG": str(abl / "base.yaml")}
        run_cli("ablation.run_pretrain_ablation", cwd=abl,
                env={**aenv, "SSRL_ABLATION_FRACTIONS": "1.0"})
        run_cli("ablation.run_train_ablation", cwd=abl,
                env={**aenv, "SSRL_ABLATION_FRACTIONS": "100",
                     "SSRL_ABLATION_LABELS": str(CLI_LABELS)})
        run_cli("ablation.run_baseline_ablation", cwd=abl,
                env={**aenv, "SSRL_ABLATION_LABELS": str(CLI_LABELS)})
        runs = ["pretrain/mae_100", f"train/mae_000_{CLI_LABELS}"] + [
            f"train/mae_100_{CLI_LABELS}_{m}" for m in ("frozen", "unfreeze1", "unfreeze2",
                                                         "full")]
        for r in runs:
            check_files(abl / "outputs" / r, ("checkpoints/best.ckpt",))
        print(f"  ablation cells: {len(runs)} runs wrote their best.ckpt", flush=True)
    return total

# phase 19: the lineage paths of the training step, route -> (environment,
# augment); each runs the same branch launches per step as the main path
# of its task (phases 4, 8 and 15)
LINEAGE = {"augment off": ({}, False),
           "SSRL_AUG_PATCHES=0": ({"SSRL_AUG_PATCHES": "0"}, True),
           "SSRL_MAE_DENSE_LOSS=1": ({"SSRL_MAE_DENSE_LOSS": "1"}, True),
           "SSRL_JEPA_DENSE_LOSS=1": ({"SSRL_JEPA_DENSE_LOSS": "1"}, True)}
LINEAGE_ROUTES = {"mae": ("augment off", "SSRL_AUG_PATCHES=0", "SSRL_MAE_DENSE_LOSS=1"),
                  "jepa": ("augment off", "SSRL_JEPA_DENSE_LOSS=1"),
                  "classifier": ("augment off",)}
LINEAGE_ENV = ("SSRL_AUG_PATCHES", "SSRL_MAE_DENSE_LOSS", "SSRL_JEPA_DENSE_LOSS")


def lineage_env(route: str):
    """The route's switches set and the others unset, inside the block."""
    env, _ = LINEAGE[route]
    return env_vars(**{k: env.get(k) for k in LINEAGE_ENV})


def lineage_paths(cfg: dict, name: str):
    """Phase 19: the MAE, JEPA and classifier steps on each lineage route at
    B=768 with exact launches, then at B=16 against the plain CPU path.
    Returns the launches and ms/step by route."""
    model_cfg = cfg["model"]
    launches = dict.fromkeys(launch_counts(), 0)
    ms = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for route in LINEAGE_ROUTES["mae"]:
        pre = {**PRE_CFG, "augment": LINEAGE[route][1]}
        with lineage_env(route):
            counts, ms[f"mae {route}"] = mae_step(model_cfg, name, "auto", pre_cfg=pre,
                                                  route=route)
            add(counts)
            cpu_agreement(model_cfg, "auto", pre_cfg=pre, route=route)
    for route in LINEAGE_ROUTES["jepa"]:
        jcfg = {**cfg["jepa"], "batch_size": BATCH, "augment": LINEAGE[route][1]}
        with lineage_env(route):
            counts, ms[f"jepa {route}"] = jepa_step(model_cfg, jcfg, name, fused=False,
                                                    route=route)
            add(counts)
            jepa_cpu_agreement(model_cfg, jcfg, route=route)
    train_cfg = {**cfg["train"], "batch_size": BATCH}
    with lineage_env("augment off"):
        counts, cls_ms = classifier_steps(model_cfg, train_cfg, name, policies=("full",),
                                          augment=False)
        add(counts)
        ms["classifier full augment off"] = cls_ms["full"]
        classifier_cpu_agreement(model_cfg, train_cfg, policies=("full",), augment=False)
    return launches, ms


# phase 20: data parallelism on the one card
DP_RANKS = 2


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_task(kind: str, cfg: dict):
    """The flagship MAE or JEPA task (bf16, auto) of phases 4 and 8."""
    if kind == "mae":
        return MAETask(cfg["model"], PRE_CFG, dtype=torch.bfloat16, device="cuda")
    return JEPATask(cfg["model"], {**cfg["jepa"], "batch_size": BATCH},
                    dtype=torch.bfloat16, device="cuda")


def dp_launches(kind: str) -> dict:
    return mae_launches("auto") if kind == "mae" else jepa_launches(False)


def dp_world_one(cfg: dict) -> dict:
    """Phase 20 (a): a one-rank ``nccl`` group in this process. One MAE and
    one JEPA step over its data axis (the global draw sliced, the loss
    denominator, gradients and sums all-reduced) against the same step
    without a group, from the same seed and so the same draws: params,
    sums and EMA target bit for bit. PyTorch's deterministic algorithms are
    on for both (the gather's backward adds overlapping JEPA target rows
    with atomics otherwise); the kernels are deterministic as they are."""
    import torch.distributed as dist

    launches = dict.fromkeys(launch_counts(), 0)
    batch = flagship_images()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        axis = get_data_axis()
        for kind in ("mae", "jepa"):
            runs = []
            for a in (None, axis):
                task = dp_task(kind, cfg)
                state = task.init_state(0)
                task.configure_sharding(a)
                reset_counts()
                state, sums = task.train_step(state, batch, 0, task.epoch_context(0))
                torch.cuda.synchronize()
                got = launch_counts()
                if got != expected(dp_launches(kind)):
                    fail(f"{kind} step, data axis {a}: launches {got}")
                for k, v in got.items():
                    launches[k] += v
                runs.append((state, sums))
            (s0, m0), (s1, m1) = runs
            diff = [k for k in s0.params if not torch.equal(s0.params[k], s1.params[k])]
            diff += [k for k in m0 if k != "lr" and not torch.equal(m0[k], m1[k])]
            if s0.extra is not None:
                diff += [k for k in s0.extra if not torch.equal(s0.extra[k], s1.extra[k])]
            print(f"  {kind} step over a one-rank nccl group vs no group: {len(s0.params)} "
                  f"params, {len(m0) - 1} sums"
                  + ("" if s0.extra is None else f", {len(s0.extra)} EMA tensors")
                  + f"; {len(diff)} differ", flush=True)
            if diff:
                fail(f"{kind}: the one-rank group's step differs from the step without a "
                     f"group in {diff[:6]}")
    finally:
        torch.use_deterministic_algorithms(old)
        dist.destroy_process_group()
    return launches


def dp_worker(out_dir: pathlib.Path, backend: str, timed: bool) -> None:
    """One rank of phase 20 (b) or of ``--dp-cards``, a process of its own:
    its rows of the global batch through one MAE and one JEPA step over a
    ``backend`` group; the gradients of the first step (and its launches),
    then a whole ``train_step``, and rank 0's params and EMA target
    broadcast against its own. ``timed``: then WARMUP + STEPS steps of
    BATCH rows on this rank (the global batch BATCH times the ranks),
    CUDA-event ms/step after the ranks line up."""
    if not maybe_initialize_distributed("cuda", backend=backend):
        fail("dp worker: no process group in the environment")
    _build.load()
    axis = get_data_axis()
    cfg = load_config(REPO / "configs" / "mae.yaml")
    b = BATCH // axis.size
    full = flagship_images()
    batch = {k: v[axis.rank * b:(axis.rank + 1) * b] for k, v in full.items()}
    out = {}
    for kind in ("mae", "jepa"):
        task = dp_task(kind, cfg)
        state = task.init_state(0)
        task.configure_sharding(axis)
        ctx = task.epoch_context(0)
        reset_counts()
        names, grads, sums = task.gradients(state, batch, ctx)
        torch.cuda.synchronize()
        launches = launch_counts()
        state, _ = task.train_step(state, batch, 0, ctx)
        torch.cuda.synchronize()
        both = launch_counts()
        params = list(state.params.values())
        extra = [] if state.extra is None else list(state.extra.values())
        same = [torch.equal(a, b) for a, b in zip(params + extra, broadcast_from(params + extra))]
        out[kind] = {"names": names, "grads": [g.float().cpu() for g in grads],
                     "sums": {k: float(v) for k, v in sums.items()}, "launches": launches,
                     "launches_with_step": both,
                     "params_equal_rank0": all(same[:len(params)]),
                     "extra_equal_rank0": all(same[len(params):])}
        if timed:
            for _ in range(WARMUP):
                state, _ = task.train_step(state, full, 0, ctx)
            broadcast_from([torch.zeros(1, device=full["weight"].device)])
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(STEPS):
                state, _ = task.train_step(state, full, 0, ctx)
            end.record()
            torch.cuda.synchronize()
            out[kind]["ms"] = start.elapsed_time(end) / STEPS
        del task, state
        torch.cuda.empty_cache()
    torch.save(out, out_dir / f"rank{axis.rank}.pt")
    torch.distributed.destroy_process_group()


def single_ms(task) -> float:
    """CUDA-event ms/step of ``task`` at B=BATCH on this process's card."""
    state = task.init_state(0)
    batch, ctx = flagship_images(), task.epoch_context(0)
    for _ in range(WARMUP):
        state, _ = task.train_step(state, batch, 0, ctx)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(STEPS):
        state, _ = task.train_step(state, batch, 0, ctx)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / STEPS


def dp_ranks(cfg: dict, ranks: int = DP_RANKS, backend: str = "gloo",
             shared_card: bool = True):
    """Phase 20 (b) (``ranks`` processes sharing the card over ``gloo``:
    ``nccl`` refuses two ranks on one device) or ``--dp-cards`` (one
    process per card over ``nccl``): each rank takes BATCH / ranks rows of
    the global batch, against this process's single step on the whole
    batch: the loss within LOSS_RTOL, every gradient within STEP_GRAD_REL,
    exact launches per rank, and rank 0's params and EMA target equal to
    every rank's. On separate cards also the ms/step of each rank at BATCH
    rows a rank beside this process's single-card step. Returns the ranks'
    launches and, on separate cards, the times."""
    import tempfile

    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    launches = dict.fromkeys(launch_counts(), 0)
    timed = not shared_card
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--dp-worker", tmp, backend,
             "timed" if timed else "untimed"], cwd=REPO,
            env={**os.environ, "RANK": str(r), "WORLD_SIZE": str(ranks),
                 "LOCAL_RANK": "0" if shared_card else str(r),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(ranks)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600))
        finally:
            for p in procs:
                p.kill()
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"dp rank {r} exited {p.returncode}\n{out[-3000:]}\n{err[-3000:]}")
        print(f"  {ranks} {backend} ranks on {'one card' if shared_card else 'their cards'}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        results = [torch.load(pathlib.Path(tmp) / f"rank{r}.pt", weights_only=False)
                   for r in range(ranks)]
    times = {}
    for kind in ("mae", "jepa"):
        task = dp_task(kind, cfg)
        state = task.init_state(0)
        names, grads, sums = task.gradients(state, flagship_images(), task.epoch_context(0))
        want_loss = sums["loss_sum"].item() / BATCH
        for r, rk in enumerate(x[kind] for x in results):
            what = f"{kind} rank {r} of {ranks}"
            if (rk["launches"] != expected(dp_launches(kind))
                    or rk["launches_with_step"] != expected(dp_launches(kind), 2)):
                fail(f"{what}: launches {rk['launches']} (then {rk['launches_with_step']} "
                     f"with the train step), expected {dp_launches(kind)} per step")
            for k, v in rk["launches_with_step"].items():
                launches[k] += v
            if rk["names"] != names:
                fail(f"{what}: trains {len(rk['names'])} tensors, the single step {len(names)}")
            loss = rk["sums"]["loss_sum"] / BATCH
            worst = 0.0
            for k, a, b in zip(names, rk["grads"], grads):
                b = b.float().cpu()
                err = (a - b).abs().max().item()
                lim = STEP_GRAD_REL * b.abs().max().item() + 1e-6
                worst = max(worst, err / lim)
                if not err <= lim:
                    fail(f"{what} gradient {k}: max abs err {err:.3e} > {lim:.3e}")
            print(f"  {what}: loss {loss:.6f} (single process at B={BATCH}: {want_loss:.6f}); "
                  f"{len(names)} gradients, the worst at {worst:.3f} of its bound; params "
                  f"equal rank 0's: {rk['params_equal_rank0']}"
                  + (f", EMA target: {rk['extra_equal_rank0']}" if kind == "jepa" else ""),
                  flush=True)
            if not abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss):
                fail(f"{what}: loss {loss} vs {want_loss} (rtol {LOSS_RTOL})")
            if not (rk["params_equal_rank0"] and rk["extra_equal_rank0"]):
                fail(f"{what}: its params or EMA target differ from rank 0's")
        if timed:
            one = single_ms(task)
            many = max(x[kind]["ms"] for x in results)
            times[kind] = {"ranks": ranks, "single_card_ms": one, "ms_per_rank": many,
                           "scaling": ranks * one / many}
            print(f"  {kind}: {ranks} cards at B={BATCH} each (global {ranks * BATCH}): "
                  f"{many:.3f} ms/step (slowest rank), {ranks * BATCH / many * 1e3:.1f} img/s; "
                  f"one card at B={BATCH}: {one:.3f} ms/step, {BATCH / one * 1e3:.1f} img/s; "
                  f"scaling {ranks * one / many:.2f} of {ranks}", flush=True)
        del task, state
        torch.cuda.empty_cache()
    return launches, times


def dp_cli(cfg: dict, nproc: int = 1) -> None:
    """Phase 20 (c): ``pretrain_mae`` under ``python -m
    torch.distributed.run --standalone --nproc_per_node nproc`` for one epoch
    on phase 17's synthetic STL-10 at BATCH rows a rank: it joins an
    ``nproc``-rank group and rank 0 writes its output layout."""
    import copy
    import tempfile

    import yaml

    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = pathlib.Path(tmp)
        write_synthetic_stl10(tmp / "data", *CLI_DATA, seed=0, class_signal="texture")
        c = copy.deepcopy(cfg)
        c["pretrain"].update(batch_size=BATCH * nproc, total_epochs=1, warmup_epochs=1)
        c["logging"].update(output_dir_base=str(tmp / "outputs"))
        (tmp / "cfg.yaml").write_text(yaml.safe_dump(c))
        env = {k: v for k, v in os.environ.items() if k != "SSRL_TORCH_DEVICE"}
        env["SSRL_DATA_DIR"] = str(tmp / "data")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(nproc), "-m", f"{CLI}.training.pretrain_mae", "--config", str(tmp / "cfg.yaml"),
             "--output_dir_suffix", "dp"], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=600)
        print(f"  torch.distributed.run pretrain_mae: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode != 0:
            fail(f"pretrain_mae under torch.distributed.run exited {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        if f"Data parallel: rank 0 of {nproc} on cuda:0" not in proc.stdout:
            fail(f"pretrain_mae under torch.distributed.run joined no group\n{proc.stdout[-2000:]}")
        run = tmp / "outputs" / "pretrain" / "dp"
        check_files(run, CLI_FILES + ("vit-mae.pt",))
        lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().split("\n") if x]
        print(f"  its metrics.jsonl: {lines[-1]}", flush=True)
        if not (len(lines) == 1 and math.isfinite(lines[0]["train_loss"])):
            fail(f"pretrain_mae under torch.distributed.run: metrics {lines}")


def data_parallel(cfg: dict) -> dict:
    """Phase 20: (a), (b) and (c) above; returns the launches of (a) and (b)."""
    launches = dp_world_one(cfg)
    for k, v in dp_ranks(cfg)[0].items():
        launches[k] += v
    dp_cli(cfg)
    return launches


def dp_cards(n: int) -> None:
    """``python3 chip_smoke.py --dp-cards N`` on a host with N cards: the
    build, then phase 20 (b) with one process per card over ``nccl`` (the
    ranks against this process's step on card 0, then each rank's ms/step
    at BATCH rows beside the single card's) and (c) with N processes."""
    if torch.cuda.device_count() < n:
        fail(f"--dp-cards {n}: {torch.cuda.device_count()} cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cards: {card()} x {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = load_config(REPO / "configs" / "mae.yaml")
    launches, times = dp_ranks(cfg, n, "nccl", shared_card=False)
    dp_cli(cfg, nproc=n)
    print(json.dumps({"dp_cards": times, "launches": launches}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

# phase 21: the bench's steady-state mode, Task.train_steps_fused
FUSED_N = 5           # steps on each side of the equality checks
FUSED_TIMED = 10      # steps timed with CUDA events per mode
FUSED_PROFILED = 5    # steps under torch.profiler per mode
FUSED_TASKS = ("mae", "jepa", "classifier")
FUSED_ROUTES = (("packed", False), ("pallas", False), ("block", False), ("chain", False),
                ("auto", True))  # MAE; True: SSRL_FUSED_EMBED=1
# the keys of the JSON line bench.py prints (bench.py:167-190)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "batch_size", "steps", "dispatch",
              "chips", "images_per_sec_per_chip", "step_time_ms", "platform",
              "flops_per_image", "peak_tflops", "mfu", "device_step_ms"]
NATIVE_FIXTURE = REPO / "tests" / "fixtures" / "jax_native_classifier.ckpt"
NATIVE_MODEL = {"general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
                "encoder": {"embed_dim": 48, "depth": 1, "num_heads": 4},
                "head": {"pool": "cls"}}


def bench_task(kind: str, impl: str = "auto"):
    """The task ``python -m ssrl_vit_mae_jepa_torch.bench --task kind``
    times, on the card."""
    return bench.make_task(bench.parse_args(["--task", kind, "--attn-impl", impl]), "cuda")


def state_tensors(state) -> dict:
    """Every tensor a step writes, by a readable name."""
    opt = state.opt_state
    out = {f"param {k}": v.detach() for k, v in state.params.items()}
    out.update({f"mu {i}": t for i, t in enumerate(opt.mu)})
    out.update({f"nu {i}": t for i, t in enumerate(opt.nu)})
    out.update({f"ema {k}": v for k, v in (state.extra or {}).items()})
    out.update({"count": opt.count, "learning_rate": opt.learning_rate})
    return out


@contextlib.contextmanager
def deterministic(on: bool):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def eager_and_fused(kind: str, impl: str, embed: bool, exact: bool, axis=None):
    """FUSED_N eager steps and ``train_steps_fused(FUSED_N)`` from two tasks
    made alike (the same seeded state, the data axis ``axis``); returns both
    tasks and states, the last sums and each side's host launch counts."""
    with fused_embed(embed), deterministic(exact):
        out = []
        for fused in (False, True):
            task = bench_task(kind, impl)
            task.configure_sharding(axis)
            state = task.init_state(0)
            batch, ctx = flagship_images(), task.epoch_context(0)
            torch.cuda.synchronize()
            reset_counts()
            if fused:
                state, sums = task.train_steps_fused(state, batch, 0, ctx, FUSED_N)
            else:
                for _ in range(FUSED_N):
                    state, sums = task.train_step(state, batch, 0, ctx)
            torch.cuda.synchronize()
            out.append((task, state, sums, launch_counts()))
    return out


def fused_equality(kind: str, impl: str = "auto", embed: bool = False, axis=None) -> dict:
    """Phase 21 (a) / (d) / (g): replays against eager steps, bit for bit
    under deterministic algorithms; on the main path also with the default
    algorithms, each tensor within 2·FUSED_N·lr (two Adam runs part by at
    most ±lr a step per element, the EMA by less), the draws and a
    replay's kernels. Returns the host launch counts of the runs (the eager
    steps' and the eager step plus the capture)."""
    what = (f"{kind} attn_impl={impl}{' SSRL_FUSED_EMBED=1' if embed else ''}"
            f"{' over a one-rank nccl group' if axis is not None else ''}")
    (te, se, sums_e, ce), (tg, sg, sums_g, cg) = eager_and_fused(kind, impl, embed, True, axis)
    if sg.step != se.step or int(sg.opt_state.count) != FUSED_N:
        fail(f"{what}: step {sg.step}, count {int(sg.opt_state.count)} after {FUSED_N} steps")
    a, b = state_tensors(se), state_tensors(sg)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    differ += [k for k in sums_e if k != "lr" and not torch.equal(sums_e[k], sums_g[k])]
    if not torch.equal(se.generator.get_state(), sg.generator.get_state()):
        differ.append("generator")
    print(f"  {what}: {FUSED_N} replayed vs eager steps, deterministic algorithms: "
          f"{len(differ)} of {len(a) + len(sums_e)} tensors differ", flush=True)
    if differ:
        fail(f"{what}: the replayed steps differ from the eager ones in {differ[:8]}")
    # the capture launches one step's kernels, a replay none (host counters)
    if any(cg[k] * FUSED_N != ce[k] * 2 for k in ce):
        fail(f"{what}: eager {ce} vs one eager step and the capture {cg}")
    counts = {k: ce[k] + cg[k] for k in ce}
    if impl == "auto" and not embed and axis is None:
        (te, se, _, ce2), (tg, sg, _, cg2) = eager_and_fused(kind, impl, embed, False)
        lr = float(se.opt_state.learning_rate)
        a, b = state_tensors(se), state_tensors(sg)
        worst = max((a[k].float() - b[k].float()).abs().max().item() for k in a)
        n_diff = sum(int(not torch.equal(a[k], b[k])) for k in a)
        print(f"  {what}, default algorithms: {n_diff} of {len(a)} tensors differ, "
              f"max |diff| {worst:.3e} (bound 2*{FUSED_N}*lr = {2 * FUSED_N * lr:.3e})",
              flush=True)
        if worst > 2 * FUSED_N * lr:
            fail(f"{what}: replayed vs eager steps differ by {worst} with the default algorithms")
        counts = {k: counts[k] + ce2[k] + cg2[k] for k in counts}
        replay_draws(te, se)
        launches_per_replay(tg, sg, what)
    del te, se, tg, sg
    torch.cuda.empty_cache()
    return counts


def replay_draws(task, state) -> None:
    """A CUDA graph of the step's draws alone, the generator registered:
    replays 1 and 2 draw other masks, each equal to the eager draw from a
    copy of the generator's state."""
    ctx = task.epoch_context(0)
    copy = torch.Generator("cuda")
    copy.set_state(state.generator.get_state())
    eager = [task.draw(copy, BATCH, ctx) for _ in range(2)]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(state.generator)
    with torch.cuda.graph(graph):
        static = task.draw(state.generator, BATCH, ctx)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append([t.clone() for t in static if t is not None])
    torch.cuda.synchronize()
    masks = [r[-1] for r in replays]
    same = [all(torch.equal(x, y) for x, y in zip(r, [t for t in e if t is not None]))
            for r, e in zip(replays, eager)]
    print(f"  draws: replays 1 and 2 masks differ: {not torch.equal(*masks)}; each equals "
          f"the eager draw: {same}", flush=True)
    if torch.equal(*masks) or not all(same):
        fail("the graph's draws repeat or differ from the eager draws")


def kernel_counts(fn, n: int) -> dict:
    """Kernel name → launches of one call of ``fn``: ``n`` calls, each in a
    torch.profiler session of its own, and per name the count most of them
    recorded (a session now and then records one call's kernels other than
    the rest's)."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(n + PROFILER_SESSIONS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {k: c for k, (_, c) in kernel_times(prof).items()}
        if counts:
            seen.append(counts)
        if len(seen) == n:
            break
        time.sleep(0.1)
    if not seen:
        fail(f"no kernels recorded in {n + PROFILER_SESSIONS} profiler sessions")
    names = set().union(*seen)
    out = {}
    for k in names:
        values = [c.get(k, 0) for c in seen]
        out[k] = max(set(values), key=values.count)
        if len(set(values)) > 1:
            print(f"  (profiled calls differ at {k[:80]}: {values})", flush=True)
    return {k: v for k, v in out.items() if v}


def _memcpy_as_one(counts: dict) -> dict:
    """Kernel counts with every device-to-device copy under one name: a
    graph runs its copy nodes as memcpy kernels of their own
    (``memcpy32_post``, ``memcpy128``) where an eager step records
    ``Memcpy DtoD``."""
    out = {}
    for k, v in counts.items():
        key = "memcpy, device to device" if "memcpy" in k.lower() else k
        out[key] = out.get(key, 0) + v
    return out


def launches_per_replay(task, state, what: str, attempts: int = 3) -> None:
    """Phase 21 (b): one replay's kernels, by name and count, are one eager
    step's (``Task.update``, the captured work) and the two int64 fills
    with which a replay first writes the registered generator's seed and
    offset. A profiler session now and then misses kernels, so a mismatch
    is measured again, ``attempts`` times in all, before it fails."""
    graph = task._graph
    ctx = task.epoch_context(0)
    for attempt in range(attempts):
        eager = _memcpy_as_one(kernel_counts(
            lambda: task.update(state, graph.inputs, 0, ctx), 3))
        replay = _memcpy_as_one(kernel_counts(graph.graph.replay, 3))
        diff = {k: replay.get(k, 0) - eager.get(k, 0) for k in set(eager) | set(replay)}
        diff = {k: v for k, v in diff.items() if v}
        prologue = {k: v for k, v in diff.items() if "FillFunctor<long>" in k}
        print(f"  {what}: a replay launches {sum(replay.values()):.0f} kernels of "
              f"{len(replay)} names, an eager step {sum(eager.values()):.0f} of "
              f"{len(eager)}; the replay's own: {prologue}", flush=True)
        if diff == prologue and sum(prologue.values()) == 2:
            return
        print(f"  (attempt {attempt + 1}: replay vs eager kernels differ: "
              f"{dict(list(diff.items())[:8])})", flush=True)
    fail(f"{what}: a replay's kernels differ from an eager step's in {attempts} attempts")


def device_busy(fn, calls: int):
    """(device ms per call, idle share) of ``calls`` calls of ``fn`` under
    torch.profiler: the kernels' summed durations, and the share of the
    span from the first kernel's start to the last one's end in which no
    kernel ran. None where no session of PROFILER_SESSIONS records one."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                 and e.time_range.end > e.time_range.start]
        if spans:
            busy = sum(b - a for a, b in spans)
            span = max(b for _, b in spans) - min(a for a, _ in spans)
            return busy / 1e3 / calls, 1.0 - busy / span
        time.sleep(0.1)
    return None


def fused_timing(kind: str) -> dict:
    """Phase 21 (c): per-step and fused ms/step (CUDA events), device
    ms/step and idle share (torch.profiler, another run of the same
    calls) and MFU at B=768."""
    task = bench_task(kind)
    state = task.init_state(0)
    batch, ctx = flagship_images(), task.epoch_context(0)
    flops = task_flops_per_image(task, ctx)
    for _ in range(WARMUP):
        state, _ = task.train_step(state, batch, 0, ctx)
    state, _ = task.train_steps_fused(state, batch, 0, ctx, 2)  # the capture
    torch.cuda.reset_peak_memory_stats()
    modes = {
        "per-step": (lambda: task.train_step(state, batch, 0, ctx), 1),
        "fused": (lambda: task.train_steps_fused(state, batch, 0, ctx, FUSED_TIMED),
                  FUSED_TIMED),
    }
    out = {}
    for mode, (fn, per_call) in modes.items():
        calls = FUSED_TIMED // per_call
        ms = cuda_ms(fn, iters=calls, warmup=1) / per_call
        prof = device_busy(fn, calls)
        dev, idle = (None, None) if prof is None else (prof[0] / per_call, prof[1])
        ips = BATCH / ms * 1e3
        # idle two ways: within the profiled run's kernel span (the
        # profiler's own host work included), and device ms against the
        # CUDA-event time of the unprofiled run (two runs; §5's convention)
        out[mode] = {"ms": ms, "device_ms": dev, "idle": idle,
                     "idle_vs_events": None if dev is None else 1.0 - dev / ms,
                     "img_s": ips, "mfu": flops * ips / PEAK_FLOPS}
        device = ("device time not recorded" if prof is None else
                  f"device {dev:.3f} ms/step, idle {100 * idle:.1f}% of the profiled span, "
                  f"{100 * (1 - dev / ms):.1f}% of the CUDA-event time")
        print(f"  {kind} {mode}: {ms:.3f} ms/step (CUDA events), {ips:.1f} img/s; {device}, "
              f"MFU {100 * flops * ips / PEAK_FLOPS:.2f}% ({flops} FLOP/image)", flush=True)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del task, state
    torch.cuda.empty_cache()
    return out


def bench_cli(tmp: pathlib.Path) -> dict:
    """Phase 21 (e): the bench as a process per task, ``--fused``."""
    env = {k: v for k, v in os.environ.items() if k != "SSRL_TORCH_DEVICE"}
    out = {}
    for kind in FUSED_TASKS:
        args = ["--task", kind, "--fused", "--steps", "10", "--warmup", "3"]
        if kind == "mae":
            args += ["--profile-dir", str(tmp / "prof")]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ssrl_vit_mae_jepa_torch.bench", *args],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        print(f"  python -m ssrl_vit_mae_jepa_torch.bench {' '.join(args)}: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode != 0:
            fail(f"bench --task {kind}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        last = json.loads(lines[-1])
        print(f"  {lines[-1]}", flush=True)
        if (list(last) != BENCH_KEYS or last["platform"] != "gpu" or last["mfu"] is None
                or last["dispatch"] != "fused"
                or (kind == "mae" and last["device_step_ms"] is None)):
            fail(f"bench --task {kind}: unexpected last line {last}")
        out[kind] = last
    return out


def native_checkpoint(cfg: dict) -> dict:
    """Phase 21 (f): a JAX-native checkpoint read by ``load_any`` here,
    then one classifier step on the card from its weights."""
    import importlib.util

    kind, state, meta = load_any(NATIVE_FIXTURE)
    weights, report, _ = classifier_params_from_checkpoint(NATIVE_FIXTURE, depth=1)
    print(f"  {NATIVE_FIXTURE.name}: {kind}, {len(state)} tensors, epoch {meta.get('epoch')}; "
          f"msgpack installed: {importlib.util.find_spec('msgpack') is not None}, loaded: "
          f"{'msgpack' in sys.modules}", flush=True)
    if kind != "native" or report != {"missing": [], "unexpected": []}:
        fail(f"{NATIVE_FIXTURE.name}: {kind}, {report}")
    task = ClassifierTask(NATIVE_MODEL, {**cfg["train"], "batch_size": 16},
                          dtype=torch.bfloat16, device="cuda")
    st = task.init_state(0, init_params_override=lambda p: weights)
    if not all(torch.equal(st.params[k].detach().cpu(), v) for k, v in weights.items()):
        fail("the native checkpoint's weights did not load")
    before = {k: v.detach().clone() for k, v in st.params.items()}
    reset_counts()
    st, sums = task.train_step(st, flagship_images(n=16), 0)
    torch.cuda.synchronize()
    counts = launch_counts()
    loss = float(sums["loss_sum"]) / 16
    print(f"  one classifier step from it: loss {loss:.5f}, launches {counts}", flush=True)
    if not math.isfinite(loss):
        fail(f"non-finite loss {loss} from the native checkpoint")
    check_moved(before, {k: v.detach() for k, v in st.params.items()}, "native checkpoint step")
    return counts


def fused_nccl() -> dict:
    """Phase 21 (g): in a one-rank ``nccl`` group the fused MAE steps
    capture the step's all-reduces; replays equal eager steps over the
    same group as in (a)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        return fused_equality("mae", axis=get_data_axis())
    finally:
        dist.destroy_process_group()


def fused_replay_process() -> tuple:
    """Phase 21 in a process of its own (``chip_smoke.py --fused-replay``):
    after the earlier phases' many profiler sessions, this process's
    profiler records some calls' kernels in the wrong session, and (b) and
    (c) read kernels by session. Returns the child's (launch counts,
    timings); its output goes to ours."""
    out = REPO / "build" / f"tmp_fused_{os.getpid()}.json"
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--fused-replay",
                               str(out)], cwd=REPO, timeout=900)
        print(f"  phase 21's process: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode != 0:
            fail(f"phase 21's process exited {proc.returncode}")
        result = json.loads(out.read_text())
    finally:
        out.unlink(missing_ok=True)
    return result["counts"], result["timing"]


def fused_replay_main(out: pathlib.Path) -> None:
    """``--fused-replay OUT``: phase 21 on the kernels the parent built; its
    launch counts and timings as JSON in OUT."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    counts, timing = fused_replay(load_config(REPO / "configs" / "mae.yaml"))
    out.write_text(json.dumps({"counts": counts, "timing": timing}))


def fused_replay(cfg: dict):
    """Phase 21; returns (host launch counts of its main-path runs, the
    timings)."""
    counts = dict.fromkeys(launch_counts(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    print("phase 21 (a, b): replayed vs eager steps, the draws, a replay's kernels",
          flush=True)
    for kind in FUSED_TASKS:
        add(fused_equality(kind))
    print("phase 21 (c): per-step and fused ms/step at B=768", flush=True)
    timing = {kind: fused_timing(kind) for kind in FUSED_TASKS}
    print("phase 21 (d): MAE on the other routes", flush=True)
    for impl, embed in FUSED_ROUTES:
        add(fused_equality("mae", impl, embed))
    print("phase 21 (e): the bench CLI", flush=True)
    tmp = REPO / "build" / f"tmp_bench_{os.getpid()}"
    try:
        timing["cli"] = bench_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 21 (f): a JAX-native checkpoint", flush=True)
    add(native_checkpoint(cfg))
    print("phase 21 (g): the all-reduces captured, in a one-rank nccl group", flush=True)
    add(fused_nccl())
    return counts, timing


# phase 22: checkpoint fidelity at configs/mae.yaml's widths: the port's
# parity_check, run_parity_protocol and convert_torch_checkpoint on three
# reference-layout stand-ins made from a seed, and a resume from a
# JAX-native trainer checkpoint
PARITY_TOL = 1e-3     # parity_check's default: features, MAE pred; logits 10x
PARITY_BAR = 0.5      # run_parity_protocol's probe top-1 bar in points
PARITY_FILES = {"encoder": "vit-encoder.pt", "mae": "vit-mae.ckpt",
                "classifier": "mae_100_400.pt"}
PARITY_DATA = (1000, 800, 100)  # train, test, unlabeled images (texture)


def standin_block(r, D: int, prefix: str) -> dict:
    """One timm block's tensors (torch layouts), seeded normals."""
    return {prefix + k: r.normal(mean, std, shape) for k, (mean, std, shape) in {
        "norm1.weight": (1, 0.02, (D,)), "norm1.bias": (0, 0.02, (D,)),
        "attn.qkv.weight": (0, 0.05, (3 * D, D)), "attn.qkv.bias": (0, 0.02, (3 * D,)),
        "attn.proj.weight": (0, 0.05, (D, D)), "attn.proj.bias": (0, 0.02, (D,)),
        "norm2.weight": (1, 0.02, (D,)), "norm2.bias": (0, 0.02, (D,)),
        "mlp.fc1.weight": (0, 0.05, (4 * D, D)), "mlp.fc1.bias": (0, 0.02, (4 * D,)),
        "mlp.fc2.weight": (0, 0.05, (D, 4 * D)), "mlp.fc2.bias": (0, 0.02, (D,)),
    }.items()}


def standin_states(model_cfg: dict, seed: int = 0) -> dict:
    """kind -> a reference-layout state dict made from ``seed`` with numpy:
    a bare timm encoder, a Lightning MAE (``model.encoder.vit.*`` +
    ``model.decoder.*``) and a classifier (``encoder.*`` +
    ``head.classification.*``)."""
    r = np.random.default_rng(seed)
    g, e, d = model_cfg["general"], model_cfg["encoder"], model_cfg["decoder"]
    D, Dd, p = e["embed_dim"], d["decoder_embed_dim"], g["patch_size"]
    n_tok = (g["image_size"] // p) ** 2 + 1

    def vit():
        s = {"cls_token": r.normal(0, 0.02, (1, 1, D)),
             "pos_embed": r.normal(0, 0.02, (1, n_tok, D)),
             "patch_embed.proj.weight": r.normal(0, 0.05, (D, 3, p, p)),
             "patch_embed.proj.bias": r.normal(0, 0.02, (D,)),
             "norm.weight": r.normal(1, 0.02, (D,)), "norm.bias": r.normal(0, 0.02, (D,))}
        for i in range(e["depth"]):
            s.update(standin_block(r, D, f"blocks.{i}."))
        return s

    dec = {"decoder_embed.weight": r.normal(0, 0.05, (Dd, D)),
           "decoder_embed.bias": r.normal(0, 0.02, (Dd,)),
           "mask_token": r.normal(0, 0.02, (1, 1, Dd)),
           "decoder_pos_embed": r.normal(0, 0.02, (1, n_tok, Dd)),
           "decoder_norm.weight": r.normal(1, 0.02, (Dd,)),
           "decoder_norm.bias": r.normal(0, 0.02, (Dd,)),
           "decoder_pred.weight": r.normal(0, 0.05, (p * p * 3, Dd)),
           "decoder_pred.bias": r.normal(0, 0.02, (p * p * 3,))}
    for i in range(d["decoder_depth"]):
        dec.update(standin_block(r, Dd, f"decoder_blocks.{i}."))
    states = {
        "encoder": vit(),
        "mae": {**{f"model.encoder.vit.{k}": v for k, v in vit().items()},
                **{f"model.decoder.{k}": v for k, v in dec.items()}},
        "classifier": {**{f"encoder.{k}": v for k, v in vit().items()},
                       "head.classification.weight": r.normal(0, 0.05, (10, D)),
                       "head.classification.bias": r.normal(0, 0.02, (10,))},
    }
    return {k: {n: torch.from_numpy(v.astype(np.float32)) for n, v in st.items()}
            for k, st in states.items()}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def parity_lines(out: str) -> str:
    return "; ".join(x.strip() for x in out.splitlines() if "🔬" in x or "PARITY" in x)


def check_file_quiet(pc, path, cfg) -> tuple:
    """``parity_check.check_file`` on the card in this process: (verdict,
    its printed lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = pc.check_file(path, cfg)
    return ok, buf.getvalue()


def resume_native(cfg: dict, data: pathlib.Path, tmp: pathlib.Path) -> dict:
    """Phase 22 (e): a ``Trainer`` on the card resumed from the JAX-native
    fixture (the full fine-tune at its width): params and Adam moments equal
    the file's arrays after the relayout, count and rate equal; then one
    more epoch through rows 1-5 with finite losses and exact launches."""
    from ssrl_vit_mae_jepa_torch.utils.flax_msgpack import read_native_checkpoint
    from ssrl_vit_mae_jepa_torch.utils.interop import classifier_params_to_state
    from ssrl_vit_mae_jepa_torch.utils.load import numpy_tree

    c = {**cfg, "train": {**cfg["train"], "samples_per_class": CLI_LABELS, "batch_size": 256,
                          "freeze_encoder": False, "unfreeze_last_layers": None}}

    def trainer(name: str) -> Trainer:
        return Trainer(ClassifierTask(NATIVE_MODEL, c["train"], device="cuda"), 2, tmp / name)

    tree, meta = read_native_checkpoint(NATIVE_FIXTURE)
    adam = tree["opt_state"]["inner_state"]["inner_state"]["1"]["0"]
    want = {k: classifier_params_to_state(numpy_tree(t))
            for k, t in (("params", tree["params"]), ("mu", adam["mu"]), ("nu", adam["nu"]))}
    t1 = trainer("resume_check")
    t1.init_state()
    start = t1._resume(NATIVE_FIXTURE)
    st = t1.state
    names = t1.task.tx.trainable(st.params)
    got = {"params": {k: v.detach() for k, v in st.params.items()},
           "mu": dict(zip(names, st.opt_state.mu)), "nu": dict(zip(names, st.opt_state.nu))}
    differ = [f"{what} {k}" for what in got for k, v in got[what].items()
              if not torch.equal(v.cpu(), torch.from_numpy(want[what][k]))]
    count, lr = int(st.opt_state.count), float(st.opt_state.learning_rate)
    want_lr = float(tree["opt_state"]["hyperparams"]["learning_rate"])
    print(f"  resumed {NATIVE_FIXTURE.name} on the card at epoch {start}: {len(names)} tensors "
          f"and their moments, {len(differ)} differ from the file; count {count}, lr {lr} "
          f"(file: {int(adam['count'])}, {want_lr})", flush=True)
    if differ or count != int(adam["count"]) or lr != want_lr or start != meta["epoch"] + 1:
        fail(f"resume from {NATIVE_FIXTURE.name}: {differ[:8]}, count {count}, lr {lr}, "
             f"epoch {start}")
    ctrain, cval = get_train_dataloaders(c, data)
    t2 = trainer("resumed")
    reset_counts()
    m = t2.fit(ctrain, cval, resume_from=NATIVE_FIXTURE)
    torch.cuda.synchronize()
    counts = launch_counts()
    steps, evals = len(ctrain), len(cval)  # one epoch, one block
    want_counts = expected({"attn_branch_fwd": steps, "attn_branch_bwd": steps,
                            "mlp_branch_fwd": steps + evals, "mlp_branch_bwd": steps,
                            "attn_branch_fwd_nograd": evals})
    print(f"  one more epoch from it: train_loss {m.get('train_loss')}, val_loss "
          f"{m.get('val_loss')}, launches {nonzero(counts)}", flush=True)
    if counts != want_counts or not all(math.isfinite(m[k]) for k in ("train_loss", "val_loss")):
        fail(f"the resumed epoch: {m}, launches {counts}, expected {want_counts}")
    return counts


def checkpoint_fidelity(cfg: dict) -> dict:
    """Phase 22: (a) the three stand-ins through ``parity_check`` as
    processes, then the MAE and classifier files in this process with
    exact ``branch_f32`` launches; (b) a loader patched to swap block 0's q
    and k rows fails the check; (c) ``run_parity_protocol`` on them with a
    synthetic STL-10; (d) ``convert_torch_checkpoint`` on each, read back by
    ``load_any`` equal bit for bit; (e) ``resume_native``. Returns the
    launches of the in-process runs."""
    import copy
    import re
    import tempfile

    import yaml

    from ssrl_vit_mae_jepa_torch.scripts.evaluation import parity_check as pc
    from ssrl_vit_mae_jepa_torch.scripts.weight_utils import convert_torch_checkpoint as conv

    total = dict.fromkeys(launch_counts(), 0)

    def add(c):
        for k, v in c.items():
            total[k] += v

    t_phase = time.perf_counter()
    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = pathlib.Path(tmp)
        weights = tmp / "weights"
        weights.mkdir()
        states = standin_states(cfg["model"])
        for kind, name in PARITY_FILES.items():
            blob = {"state_dict": states[kind]} if kind == "mae" else states[kind]
            torch.save(blob, weights / name)
        n_train, n_test, n_unl = PARITY_DATA
        write_synthetic_stl10(tmp / "data", num_train=n_train, num_test=n_test,
                              num_unlabeled=n_unl, seed=0, class_signal="texture")
        c = copy.deepcopy(cfg)
        c["test"]["batch_size"] = 256
        c["logging"]["output_dir_base"] = str(tmp / "outputs")
        cfg_path = tmp / "parity.yaml"
        cfg_path.write_text(yaml.safe_dump(c))

        print("phase 22 (a): parity_check on the three stand-ins", flush=True)
        started = {kind: start_cli("evaluation.parity_check", weights / name, "--config",
                                   cfg_path) for kind, name in PARITY_FILES.items()}
        for kind, proc in started.items():
            out = finish_cli(proc)
            print(f"    {PARITY_FILES[kind]}: {parity_lines(out)}", flush=True)
            if "PARITY OK" not in out:
                fail(f"parity_check {kind}: {out[-2000:]}")
        f32 = list(F32_KERNELS)
        for kind, blocks in (("mae", 4 + 4 + 2), ("classifier", 4 + 4)):
            reset_counts()
            ok, out = check_file_quiet(pc, weights / PARITY_FILES[kind], c)
            torch.cuda.synchronize()
            got = launch_counts()
            print(f"  check_file {PARITY_FILES[kind]} in process: {ok}, launches "
                  f"{nonzero(got)}; {parity_lines(out)}", flush=True)
            if not ok or got != expected(dict.fromkeys(f32, blocks)):
                fail(f"check_file {kind}: {ok}, launches {got}, expected {blocks} of each "
                     "f32 kernel")
            add(got)

        print("phase 22 (b): a loader that swaps block 0's q and k rows", flush=True)
        saved = {n: getattr(pc, n) for n in ("encoder_params_from_checkpoint",
                                             "classifier_params_from_checkpoint")}

        def swap_qk(load):
            def patched(*args, **kwargs):
                out = load(*args, **kwargs)
                key = next(k for k in out[0] if k.endswith("blocks.0.attn.qkv.weight"))
                w = out[0][key]
                n = w.shape[0] // 3
                out[0][key] = torch.cat([w[n:2 * n], w[:n], w[2 * n:]])
                return out
            return patched

        try:
            for n, load in saved.items():
                setattr(pc, n, swap_qk(load))
            ok, out = check_file_quiet(pc, weights / PARITY_FILES["classifier"], c)
        finally:
            for n, load in saved.items():
                setattr(pc, n, load)
        print(f"  check_file {PARITY_FILES['classifier']}, q and k swapped: {ok}; "
              f"{parity_lines(out)}", flush=True)
        if ok or "PARITY FAILED" not in out:
            fail("the check passed a loader that swaps q and k")

        print("phase 22 (c): run_parity_protocol", flush=True)
        out = run_cli("evaluation.run_parity_protocol", weights, "--config", cfg_path,
                      "--data-dir", tmp / "data")
        for line in out.splitlines():
            if "probe top-1" in line or "golden=" in line:
                print(f"    {line.strip()}", flush=True)
        deltas = [float(x) for x in re.findall(r"Δ ([0-9.]+) pts", out)]
        if "PROTOCOL OK" not in out or len(deltas) != 1 or deltas[0] > PARITY_BAR:
            fail(f"run_parity_protocol: deltas {deltas}\n{out[-3000:]}")

        print("phase 22 (d): convert_torch_checkpoint, read back by load_any", flush=True)
        for kind, name in PARITY_FILES.items():
            out_path = tmp / "native" / f"{kind}.ckpt"
            got_kind = conv.main([str(weights / name), str(out_path)])
            source, src, _ = load_any(weights / name)
            _, state, _ = load_any(out_path)
            if kind == "mae":
                src = {k[len("model."):]: v for k, v in src.items()}
            extra = set(state) - set(src)
            same = (got_kind == kind and source == "torch" and set(src) <= set(state)
                    and all(torch.equal(state[k], v) for k, v in src.items())
                    and all(not state[k].any() for k in extra)
                    and extra <= {"encoder.mask_token"})
            print(f"  {name} -> {out_path.name} ({got_kind}): {len(src)} tensors equal bit "
                  f"for bit: {same}; zeros added: {sorted(extra)}", flush=True)
            if not same:
                fail(f"convert_torch_checkpoint {kind}: the read-back differs")

        print("phase 22 (e): Trainer resumed from a JAX-native trainer checkpoint", flush=True)
        add(resume_native(cfg, tmp / "data", tmp))
    print(f"  phase 22: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


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
    print("phase 3f: f32 branch forwards vs plain versions (TF32 off)", flush=True)
    res.update(check_f32())

    cfg = load_config(REPO / "configs" / "mae.yaml")
    model_cfg = cfg["model"]
    jepa_cfg = {**cfg["jepa"], "batch_size": BATCH}
    launches = dict.fromkeys(launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    mae_ms = {}
    for phase, impl in ((4, "auto"), (6, "packed"), (7, "pallas")):
        print(f"phase {phase}: MAE pretraining step, attn_impl={impl}", flush=True)
        counts, mae_ms[impl] = mae_step(model_cfg, name, impl)
        add(counts)
        print(f"phase {5 if impl == 'auto' else phase}: B=16 step, attn_impl={impl}, "
              "kernels vs plain CPU path", flush=True)
        cpu_agreement(model_cfg, impl)
    print("phase 8: JEPA pretraining step, attn_impl=auto", flush=True)
    add(jepa_step(model_cfg, jepa_cfg, name, fused=False)[0])
    print("phase 9: JEPA and MAE steps with SSRL_FUSED_EMBED=1", flush=True)
    add(jepa_step(model_cfg, jepa_cfg, name, fused=True)[0])
    add(mae_step(model_cfg, name, "auto", fused=True)[0])
    print("phase 10: B=16 JEPA step, kernels vs plain CPU path", flush=True)
    jepa_cpu_agreement(model_cfg, jepa_cfg)
    for phase, impl in ((11, "block"), (12, "chain")):
        print(f"phase {phase}: MAE pretraining step, attn_impl={impl}, then B=16 "
              "kernels vs plain CPU path", flush=True)
        add(mae_step(model_cfg, name, impl)[0])
        cpu_agreement(model_cfg, impl)
    for phase, impl in ((13, "block"), (14, "chain")):
        print(f"phase {phase}: JEPA pretraining step, attn_impl={impl}, then B=16 "
              "kernels vs plain CPU path", flush=True)
        add(jepa_step(model_cfg, jepa_cfg, name, fused=False, impl=impl)[0])
        jepa_cpu_agreement(model_cfg, jepa_cfg, impl)
    train_cfg = {**cfg["train"], "batch_size": BATCH}
    print("phase 15: classifier step (full fine-tune, probe, unfreeze 2) and eval step, "
          "attn_impl=auto", flush=True)
    add(classifier_steps(model_cfg, train_cfg, name)[0])
    print("phase 16: B=16 classifier steps and eval step, kernels vs plain CPU path",
          flush=True)
    classifier_cpu_agreement(model_cfg, train_cfg)
    print("phase 17: the stage end to end: MAE fit, classifier fit from its best.ckpt, "
          "test, resume", flush=True)
    add(stage_end_to_end(cfg, mae_ms["auto"]))
    print("phase 18: the CLIs on the card: pretrain, probe, evaluate, JEPA, k-NN, features, "
          "reconstruction, ablation cells", flush=True)
    add(cli_end_to_end(cfg))
    print("phase 19: the lineage paths: MAE (augment off, SSRL_AUG_PATCHES=0, dense loss), "
          "JEPA (augment off, dense loss), classifier full fine-tune (augment off)", flush=True)
    counts, lineage_ms = lineage_paths(cfg, name)
    add(counts)
    print(json.dumps({"lineage_ms": lineage_ms}), flush=True)
    print("phase 20: data parallelism on the card: a one-rank nccl group, two gloo ranks, "
          "pretrain_mae under torch.distributed.run", flush=True)
    add(data_parallel(cfg))
    print("phase 21: the bench's steady-state mode: the train step as a CUDA-graph replay",
          flush=True)
    counts, fused_ms = fused_replay_process()
    add(counts)
    print(json.dumps({"fused_ms": fused_ms}), flush=True)
    print("phase 22: checkpoint fidelity: parity_check, run_parity_protocol, "
          "convert_torch_checkpoint, a resume from a JAX-native checkpoint", flush=True)
    add(checkpoint_fidelity(cfg))

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
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/branch_f32.cu", replaces)
             for k, (_, replaces) in F32_KERNELS.items()]
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
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(pathlib.Path(sys.argv[2]), sys.argv[3], sys.argv[4] == "timed")
    elif sys.argv[1:2] == ["--fused-replay"]:
        fused_replay_main(pathlib.Path(sys.argv[2]))
    elif sys.argv[1:2] == ["--dp-cards"]:
        dp_cards(int(sys.argv[2]))
    else:
        main()
