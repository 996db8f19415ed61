#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: kernels, then the MAE and JEPA
pretraining steps, then the classifier stage and the engine under it, then
the port's CLIs, then the lineage paths of the step and data parallelism,
then the bench's steady-state mode (the step as a CUDA-graph replay), then
checkpoint fidelity, then f32 training on every route, then the
tensor-parallel model axis, then the texture rank study at a small scale.

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
     and its bound (a ``{"gemm_table": [...]}`` line); then the LayerNorm
     backward of ``csrc/common.cuh`` alone at the five geometries with a
     backward: its four bf16 instantiations (``bf.ln_bwd``) and f32
     (``bf.branch_ln_bwd``) against their plain versions (2e-2 / 1e-4 of
     the largest magnitude), each a call with its device ms, device kernels
     (one, a memset of its done counters aside), bound and the nearest
     library call's device ms (``native_layer_norm_backward`` on the same x
     and dy, mean and rstd from an untimed ``native_layer_norm``: no
     residual gradient, no sum of gy);
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
  3d. the MLP half of the whole block and the chain alone (one kernel each
     way, ``csrc/block_mlp.cu``) at the block geometries against
     ``mlp_fwd_plain`` / ``mlp_bwd_plain``, z rounded and in f32, forward
     and all seven backward outputs, the rounded forward equal to the split
     MLP branch's bit for bit, with CUDA-event, device and plain times;
     then the whole-block kernel of ``csrc/fused_block.cu`` at the five
     block geometries of phase 3, forward and all 13 backward outputs (the
     target encoder's through the no-grad forward), against ``block_ref``,
     with the kernel's and the plain version's times;
  3e. the chained-block kernel of ``csrc/block_chain.cu`` at the five
     stacks (MAE encoder N=4 and decoder N=2, JEPA context encoder N=4 and
     predictor N=2 with the stash forward and the backward; the JEPA target
     encoder N=4 through the no-grad forward) against ``chain_ref``, with
     times; the stash forward's output equals the no-grad forward's and the
     split kernels' bit for bit. In 3d and 3e each call's device time and
     kernel launches under ``torch.profiler``, beside the split kernels'
     (rows 1 + 4 forward, 2 + 5 backward) on the same blocks; a pass fails
     unless it launches the MLP-half kernel once a block, no GELU epilogue
     of the branch GEMM (z never reaches memory) and LN1 once a block, the
     backward's qkv product once a block;
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
  23. f32 training on auto, packed and pallas, TF32 off (switched off,
     printed, restored): (a) the f32 per-product table (every product of
     rows 1-5 at f32 at the main paths' shapes through ``bf.gemm`` on f32
     operands, the SIMT GEMM of ``csrc/gemm_f32_simt.cuh`` held to
     ``gemm_ref`` at the f32 bounds and twice for the same bits; its device
     time alone and with its reductions beside ``torch.matmul`` on the same
     operands, and its bound; a ``{"gemm_f32_table": [...]}`` line and
     the GEMM's device ms per f32 MAE, JEPA and classifier step), the f32
     split branches of
     ``csrc/branch_f32.cu`` (the attention branch's stash forward and
     backward, the MLP branch's backward) at the block geometries of phase
     3 and two odd shapes, and the four attention entries at f32
     (``csrc/mha_f32.cu``) at their geometries and 33 ragged shapes, against
     their plain versions (forward within 5e-5, each gradient within 1e-4
     of its largest magnitude), a second forward and backward the same bits
     at every shape (the fit's edges (256, 32) and (1, 8) among them), the
     f32 core's blocks per SM, per-call and device times beside SDPA at f32,
     the library yardstick; (b) the
     MAE, JEPA and classifier (full, probe, unfreeze 2, eval) steps at f32,
     B=768, auto, exact f32 launches, ms/step and device ms/step; (c) MAE
     on packed and pallas at f32; (d) B=16 at f32 against the CPU (loss
     rtol 1e-5, each gradient within 1e-4 of the CPU tensor's largest
     magnitude); (e) a one-epoch f32 MAE ``Trainer.fit`` at B=256 with a
     falling loss and exact launches; (f) 3 replayed f32 MAE steps
     (``train_steps_fused``) equal to 3 eager ones bit for bit.
  24. f32 on attn_impl block and chain with ``SSRL_FUSED_EMBED=1``, TF32
     off: (a) first the f32 MLP half (``csrc/block_mlp_f32.cu``, which no
     step runs) alone against its plain versions at the block geometries,
     its forward equal to the split f32 MLP branch's bit for bit, its device
     ms beside the split branch's; the f32 whole block
     (``csrc/fused_block_f32.cu``) at the block
     geometries of phase 3, forward and all 13 backward outputs against
     ``block_ref`` (the target encoder's through the no-grad forward); the
     f32 chain (``csrc/block_chain_f32.cu``) at the MAE encoder (N=4), the
     decoder (N=2) and the no-grad JEPA target (N=4) against ``chain_ref``;
     both forwards equal to the f32 split kernels' bit for bit, a second
     backward to the first, the chain's backward to the split f32 pair's
     (rows 2 + 5) bit for bit, each call's device ms and launches beside
     the split pair's (the block: LN twice and the qkv product once a block
     each way, its backward keeping LN1 and qkv; the chain's forward the
     same, its backward, from its stash, no LN forward, no qkv and no fc1
     product), and the peak device memory and device ms of one f32 MAE
     step on the chain (``mae_step_peak_gib`` in the chain backward's
     entry); the f32 fused embed (``csrc/patch_embed_f32.cu``)
     at K=37, K=45 and no index against its plain version, with a gather +
     ``torch.matmul`` at f32 as the yardstick; forward within 5e-5, each
     backward output within 1e-4 of its largest magnitude, a second call the
     same bits; per-call times and f32 bounds; then K=1, K=L with an index,
     repeated indices and indices out of range (NaN rows, no gradient) the
     same way; (b) the MAE and JEPA steps on block and on chain and
     the classifier's full fine-tune (and eval step) on block, f32, B=768,
     with the fused embed: finite losses, moved params, exact f32 launches
     per step, ms/step and device ms/step (an ``{"f32_step_ms": ...}``
     line); (c) the same routes at B=16 against the CPU at f32 (loss rtol
     1e-5, gradients 1e-4); (d) 3 replayed f32 MAE steps on block with the
     fused embed equal to 3 eager ones bit for bit.
  25. the tensor-parallel model axis: (a) the TP entries at the shard
     widths against their plain versions, at bf16 and f32, each with its
     CUDA-event and device ms a call (in a process of its own); (b, c) two
     ranks
     in a (1, 2) grid sharing the card over ``gloo``, against one process,
     and a fit with a checkpoint and a resume.
  26. the texture rank study end to end at a small scale: ``bash
     tools/torch_rank_study.sh`` as a process on the card with
     ``SSRL_RANK_OUT`` and ``SSRL_RANK_DATA`` in a temporary directory,
     ``SSRL_RANK_EPOCHS=1`` and ``SSRL_RANK_UNLABELED=6000`` (both
     pretrainings at B=2000, every k-NN, ridge, mean-pool k-NN and probe
     stage through the port's CLIs), then
     ``tools/torch_summarize_rank_study.py`` on it: every stage exits 0,
     both ``best.ckpt`` exist, and the summary holds four cls k-NN, four
     ridge, three mean-pool k-NN and three probe rows, each in [0, 1]; each
     stage's wall time and a ``{"rank_study_small": ...}`` line; the
     launches of the study's CLI processes, summed from ``SSRL_LAUNCH_LOG``
     (each process appends its counters at exit), include every kernel of
     ``RANK_KERNELS``; (b) on the config the study wrote, one MAE and one
     JEPA step at B=2000 and at the partial last batch (200 real rows, the
     rest at weight 0): the kernels (bf16, auto) against the plain route
     (bf16, xla) on the card from the same weights and draws, the loss
     within 2e-2 and each gradient within 10% of the plain one's largest
     magnitude (phase 4's bounds), with each route's relative L2 distance
     from the plain route at f32 and a ``{"study_steps": ...}`` line.

With arguments: ``--dp-worker DIR BACKEND timed|untimed`` is one rank of
phase 20 (b), ``--fused-replay OUT`` is phase 21 in a fresh process (the
profiler of a process that ran phases 3-20 records some kernels in the
wrong session, or loses them), ``--f32-kernels 23|24 OUT`` phase 23 (a)
or 24 (a) and ``--tp-kernels OUT`` phase 25 (a) in a fresh process for the
same reason, all started by the script itself; ``--dp-cards N`` on a host with
N cards builds the kernels, runs phase 20 (b) with one process per card over
``nccl`` (then each rank's ms/step at B=768 a rank beside one card's) and
(c) with N processes, and prints a ``{"dp_cards": ...}`` line before the
last. ``--tp-worker DIR BACKEND MP check|timed`` is one rank of phase 25
(b, c) in the (world / MP, MP) grid; ``--tp-cards N`` on a host with N
cards builds the kernels and runs the flagship MAE, JEPA and full
classifier steps (bf16, auto) at B=768 a data rank in the (N/2, 2) grid
over ``nccl``, then in the (N, 1) grid, then on one card, and prints each
rank's ms/step and device ms/step and the exact TP launches in a
``{"tp_cards": ...}`` line before the last.

Each main-path run (phases 4, 6-9, 11-15, 17-26) zeroes every launch count
just before it and reads them just after. ``mha_stacked`` and ``mha_packed`` lie
on none of these paths (the JAX package reaches them from the JEPA
predictor's sub-layer route and by direct calls); phase 3b drives them.

The line before the last is ``{"kernels": [...]}`` (60 entries): per
kernel, ``ms``, ``plain_ms`` and ``bound_ms`` are per training step of
``step`` (the MAE step where it runs the kernel, else the JEPA step),
``*_jepa`` the same per JEPA step, ``*_classifier`` per full fine-tune
step of the classifier, ``*_<geometry>`` per call (``*_cls`` the
classifier's geometry); for the f32 forwards per ``extract_features``
batch of 256 (``step`` "features"), ``*_reconstruction`` per
``reconstruct_batch`` of 8; every f32 kernel's bound is the f32 CUDA-core
rate (the f32 training kernels per f32 step of ``step``). ``ms`` and
the other times are CUDA-event means of the wrapper's call, host work
included; ``device_ms`` (also of the TP entries) and ``library_device_ms``
(attention and embed rows) are the summed durations of the device kernels
(and memsets) one call launches;
the block and chain rows add ``split_device_ms`` (the split kernels on the
same blocks) and ``kernel_launches`` / ``split_kernel_launches`` (device
kernels a call), the MLP-half rows ``also_replaces`` (the chain's TPU
kernels, whose MLP half they run too).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import pathlib
import re
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
from ssrl_vit_mae_jepa_torch.parallel.mesh import (
    ShardSpec,
    broadcast_from,
    gather_params,
    get_data_axis,
    get_mesh,
    shard_index,
    shard_spec,
)
from ssrl_vit_mae_jepa_torch.parallel.multihost import maybe_initialize_distributed
from ssrl_vit_mae_jepa_torch.runtime.native import native_available
from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask
from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
from ssrl_vit_mae_jepa_torch.utils.checkpoint import load_checkpoint, model_state, restore_state
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
# the MLP half of the bf16 whole block and chain, one kernel each way
# (csrc/block_mlp.cu), per block: kernel -> the TPU kernel of the whole block
# whose MLP half it runs (the chain's are in HALF_ALSO); at f32, the keys +
# "_f32", csrc/block_mlp_f32.cu, checked alone (no f32 block or chain runs it)
HALF_KERNELS = {"mlp_half_fwd": _TPU + "block_pallas.py:408",
                "mlp_half_bwd": _TPU + "block_pallas.py:442"}
HALF_ALSO = {"mlp_half_fwd": _TPU + "block_chain.py:235, :261",
             "mlp_half_bwd": _TPU + "block_chain.py:288"}
# the branch GEMM's epilogues with a GELU (ssrl::Epi 4-7, csrc/gemm.cuh) and
# the NT bias epilogue (2, the qkv product), by kernel name; at f32 those of
# the SIMT GEMM (ssrl::F32Epi, csrc/gemm_f32.cuh: 2, 4, 5 and F_BIAS 1), and
# F_BIAS_GELU_Z (4), the fc1 product that also writes z
GELU_EPIS = {4, 5, 6, 7}
EPI_QKV = 2
GELU_EPIS_F32 = {2, 4, 5}
EPI_QKV_F32 = 1
EPI_FC1_Z_F32 = 4
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
# the classifier's full fine-tune and eval step on attn_impl="block" (phase 24)
CLS_BLOCK_LAUNCHES = {"full": {"block_fwd": 4, "block_bwd": 4, "mlp_half_fwd": 4,
                               "mlp_half_bwd": 4},
                      "eval": {"block_fwd_nograd": 4, "mlp_half_fwd": 4}}


def cls_launches(policy: str, impl: str = "auto", fused: bool = False) -> dict:
    """Launches of a classifier step under ``policy`` (or of the eval step)
    on ``impl`` (auto, or block for the full fine-tune and eval); with the
    fused embed one embed forward more, and one backward where the embed
    trains (the full fine-tune only)."""
    want = dict((CLS_BLOCK_LAUNCHES if impl == "block" else CLS_LAUNCHES)[policy])
    if fused:
        want["patch_embed_fwd"] = 1
        if policy == "full":
            want["patch_embed_bwd"] = 1
    return want


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
# phase 23, f32 training: the f32 kernels against their plain versions (TF32
# off), the forward within F32_ATOL and each backward output within
# F32_BWD_REL of the plain one's largest magnitude (+1e-6): f32 summation in
# another order over ~1e5 rows moves it by ~1e-6 of that, a layout fault by
# O(1); an f32 step at B=16, card vs CPU: the loss within F32_LOSS_RTOL and
# each gradient within F32_BWD_REL of the CPU tensor's largest magnitude
F32_BWD_REL = 1e-4
F32_LOSS_RTOL = 1e-5
DT_NAME = {torch.bfloat16: "bf16", torch.float32: "f32"}


def step_tolerances(dtype) -> tuple:
    """(loss rtol, gradient bound) of a B=16 step, card vs CPU, at ``dtype``."""
    return (F32_LOSS_RTOL, F32_BWD_REL) if dtype == torch.float32 else (LOSS_RTOL, STEP_GRAD_REL)


def launch_names(per_step: dict, dtype) -> dict:
    """Launch counts keyed for ``dtype``: an f32 kernel counts under its bf16
    twin's key + ``_f32`` (``block_fused.dtype_key``); the MLP-half kernels
    of the bf16 whole block and chain have no f32 twin on a step (the f32
    entries run the split f32 sequences)."""
    return {bf.dtype_key(dtype, k): v for k, v in per_step.items()
            if dtype == torch.bfloat16 or not k.startswith("mlp_half")}


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


def stack_bounds(L: int, D: int, N: int, stash: bool, f32: bool = False):
    """Per-call (fwd, bwd) bounds of N blocks at (B, L, D), F = 4D. Bytes:
    x and the output (dy and dx) once, the chain's stash
    (``block_chain.stash_floats``) written by its forward and read by its
    backward, bf16 (``f32``: f32) activations and weights and f32 LN params
    read once, f32 gradients written once; with ``f32`` the operations at
    the f32 CUDA-core peak. Operations per block: forward qkv 6, proj 2,
    fc1 8, fc2 8 (x MD^2) and attention 4BL^2D. Backward of the whole block
    (only x is an input): the forward up to x_mid again (8MD^2, 4BL^2D),
    the MLP's 40MD^2 (fc1 again, dh, dW2, dW1, dy2), dWp, da, dWqkv, dy1
    16MD^2, the attention backward 8BL^2D; of a bf16 chain block (a and
    x_mid stashed): qkv again 6, the MLP's 40, 16, and the attention
    backward with QK^T again 10BL^2D (62MD^2); of an f32 chain block, whose
    stash also holds LN1's output, qkv, LN2's output, z and h, neither qkv
    nor fc1 runs again: the MLP's 32, 16 (48MD^2) and 10BL^2D."""
    M = BATCH * L
    e = 4 if f32 else 2
    bnd = bound_f32 if f32 else bound
    act = M * D * e
    w = N * ((12 * D * D + 9 * D) * e + 4 * D * 4)
    grads = N * (12 * D * D + 13 * D) * 4
    att = BATCH * L * L * D
    dt = torch.float32 if f32 else torch.bfloat16
    st = bc.stash_floats(N, BATCH, L, D, 4 * D, dt) * e if stash else 0
    fwd = bnd(2 * act + st + w, N * (24 * M * D * D + 4 * att))
    if stash:
        bwd = bnd(3 * act + st + w + grads, N * ((48 if f32 else 62) * M * D * D + 10 * att))
    else:
        bwd = bnd(3 * act + w + grads, N * (64 * M * D * D + 12 * att))
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
                        "library_device_ms", "split_device_ms", "kernel_launches",
                        "split_kernel_launches")
            if all(k in v for v in per_geo.values())]
    worst = max(per_geo.values(), key=lambda v: v["bound_ms"])
    r = {"max_abs_err": err, "bound_by": worst["bound_by"], "step": runs[0]}
    for k in keys:
        r[k] = per_step(per_geo, k, calls_by_step[runs[0]])
        for later in runs[1:]:
            r[f"{k}_{later}"] = per_step(per_geo, k, calls_by_step[later])
        r.update({f"{k}_{g}": v[k] for g, v in per_geo.items()})
    return r


def branch_inputs(kind: str, L: int, D: int, seed: int, batch: int = BATCH,
                  dtype=torch.bfloat16):
    """Activations (bf16, or ``dtype``) and f32 params at realistic scales,
    on the card."""
    g = torch.Generator().manual_seed(seed)
    n = 3 * D if kind == "attn" else 4 * D
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    wb_in = D if kind == "attn" else n
    params = [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(n, D) * D**-0.5, 0.1 * rn(n),
              rn(D, wb_in) * wb_in**-0.5, 0.1 * rn(D)]
    x = rn(batch, L, D).to(dtype)
    dy = rn(batch, L, D).to(dtype)
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


# the LN backward alone (phase 3): variant -> (activation dtype, gy in f32,
# dx also in f32); bytes an element it must move (x, gy, dx in the dtype,
# dy f32; dx32 and an f32 gy 4 more each)
LN_VARIANTS = {"bf16": (torch.bfloat16, False, False),
               "bf16_gy32": (torch.bfloat16, True, False),
               "bf16_dx32": (torch.bfloat16, False, True),
               "bf16_gy32_dx32": (torch.bfloat16, True, True),
               "f32": (torch.float32, False, False)}
LN_GEOS = ("enc", "ctx", "dec", "pred", "cls")


def ln_bytes(variant: str) -> int:
    dt, gy32, dx32 = LN_VARIANTS[variant]
    e = 4 if dt == torch.float32 else 2
    return 3 * e + 4 + (2 if gy32 else 0) + (4 if dx32 else 0)


def check_ln() -> None:
    """Phase 3, last: the LayerNorm backward alone at each geometry with a
    backward (B=768): its variants against their plain versions, device
    ms, device kernels a call, bound and the nearest library call."""
    for geo in LN_GEOS:
        L, D, H = GEOMETRIES[geo]
        M = BATCH * L
        g = torch.Generator().manual_seed(L + D)
        rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
        x32, s, b = (2.0 * rn(M, D) + 0.5).cuda(), (1.0 + 0.1 * rn(D)).cuda(), (0.1 * rn(D)).cuda()
        dy, gy32 = rn(M, D).cuda(), rn(M, D).cuda()
        parts = []
        for variant, (dt, gy_f32, dx32) in LN_VARIANTS.items():
            x = x32.to(dt)
            gy = gy32 if gy_f32 or dt == torch.float32 else gy32.to(dt)
            if dt == torch.float32:
                kern = lambda: bf.branch_ln_bwd(x, s, dy, gy)  # noqa: E731
                got, want = kern(), bf.ln_bwd_plain(x, s, dy, gy)
                got, want = (got[0], *got[1]), (want[0], *want[1])
            else:
                kern = lambda: bf.ln_bwd(x, s, dy, gy, dx32=dx32)  # noqa: E731
                k, r = kern(), bf.ln_bwd_full_plain(x, s, dy, gy)
                got = (k[0],) + ((k[1],) if dx32 else ()) + tuple(k[2])
                want = (r[0],) + ((r[1],) if dx32 else ()) + tuple(r[2])
            rel = F32_BWD_REL if dt == torch.float32 else BWD_REL
            err = 0.0
            for name, k, r in zip(("dx", "dx32", "d_ln_s", "d_ln_b", "sum_gy") if dx32
                                  else ("dx", "d_ln_s", "d_ln_b", "sum_gy"), got, want):
                e_ = (k.float() - r.float()).abs().max().item()
                if not e_ <= rel * r.float().abs().max().item() + 1e-6:
                    fail(f"LN backward {variant}@{geo} {name}: max abs err {e_}")
                err = max(err, e_)
            ms = device_ms(kern)
            one = lambda c: sum(n for k, n in c.items() if "ln_bwd_kernel" in k) == 1  # noqa: E731
            kernels = {k: n for k, n in call_launches(kern, one, sessions=6).items()
                       if not k.startswith("Memset")}
            if sum(kernels.values()) != 1 or "ln_bwd_kernel" not in next(iter(kernels)):
                fail(f"LN backward {variant}@{geo}: device kernels a call {kernels}")
            bnd = ln_bytes(variant) * M * D / PEAK_BYTES * 1e3
            parts.append(f"{variant} {ms:.4f} ms, {sum(kernels.values())} kernel, bound "
                         f"{bnd:.4f} ({100 * bnd / ms:.0f}%), err {err:.2e}")
        lib = []
        for dt in (torch.bfloat16, torch.float32):
            x, w, bb = x32.to(dt), s.to(dt), b.to(dt)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [D], w, bb, bf.LN_EPS)
            dyx = dy.to(dt)
            lib.append(device_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dyx, x, [D], mean, rstd, w, bb, [True, True, True])))
        print(f"  LN backward@{geo} M={M} D={D} per call: " + "; ".join(parts)
              + f"; nearest library call (native_layer_norm_backward: no residual "
              f"gradient, no sum of gy, statistics given) bf16 {lib[0]:.4f}, f32 {lib[1]:.4f} ms",
              flush=True)
        del x32, dy, gy32


def bound_f32(nbytes: float, flops: float):
    """(ms, what bounds it): the least time for f32 work, its products at the
    f32 CUDA-core peak (no TF32)."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
    return bound_f32((2 * M * D + w) * 4, flops)


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


def stack_inputs(L: int, D: int, N: int, seed: int, dtype=torch.bfloat16):
    """bf16 (or ``dtype``) x and dy, and N blocks' 12 f32 params each, on the
    card."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    F_ = 4 * D

    def block():
        return [1.0 + 0.1 * rn(D), 0.1 * rn(D), rn(3 * D, D) * D**-0.5, 0.1 * rn(3 * D),
                rn(D, D) * D**-0.5, 0.1 * rn(D), 1.0 + 0.1 * rn(D), 0.1 * rn(D),
                rn(F_, D) * D**-0.5, 0.1 * rn(F_), rn(D, F_) * F_**-0.5, 0.1 * rn(D)]

    params = [[t.cuda() for t in block()] for _ in range(N)]
    x, dy = (rn(BATCH, L, D).to(dtype).cuda() for _ in range(2))
    return x, dy, params


def gemm_epis(counts: dict, f32: bool = False) -> dict:
    """Epilogue (``ssrl::Epi``, or with ``f32`` ``ssrl::F32Epi``) ->
    launches a call of the branch GEMM (the f32 SIMT GEMM), from
    ``device_ms``'s launches by kernel name."""
    pattern = (r"gemm_f32_kernel<\w+, \w+, \d+, \d+, \d+, (\d+)>" if f32
               else r"gemm_sm90_kernel<\w+, \w+, \d+, (\d+)>")
    out = {}
    for name, n in counts.items():
        m = re.search(pattern, name)
        if m:
            out[int(m.group(1))] = out.get(int(m.group(1)), 0) + n
    return out


def named(counts: dict, part: str) -> float:
    """Launches a call of the kernels whose names hold ``part``."""
    return sum(n for k, n in counts.items() if part in k)


def split_stack(x, params, H: int):
    """The same blocks on the split branch kernels (rows 1 + 4 forward; with
    grad their backward is rows 2 + 5)."""
    for p in params:
        x = bf.fused_mlp_branch(bf.fused_attn_branch(x, *p[:6], H), *p[6:])
    return x


def call_launches(fn, ok, sessions: int = 3) -> dict:
    """Device kernel name -> launches of one call of ``fn`` under
    ``torch.profiler``: the first of ``sessions`` sessions whose counts
    ``ok`` accepts (a session now and then loses kernels), else the last."""
    for _ in range(sessions):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
        if ok(counts):
            break
    return counts


def stack_device(kind: str, geo: str, N: int, fwd_fn, bwd_fn, x, dy, params, H: int,
                 f32: bool = False) -> dict:
    """Phases 3d / 3e (and at f32, ``f32``, phase 24 (a)): device time and
    kernel launches of one call of the forward (``fwd_fn``, with or without
    grad) and of the backward (``bwd_fn``, or None under no-grad), and the
    split kernels' on the same blocks; fails unless each pass launches the
    MLP-half kernel once a block and no GELU epilogue of the branch GEMM (z
    never reaches memory), and LN1 once a block, with the backward's qkv
    product once a block. At f32 the MLP half is the split f32 sequence, so
    each pass of the whole block must launch ``ln_f32_kernel`` twice a block
    (LN1, LN2) and the qkv product (F_BIAS) once a block: its backward keeps
    LN1 and qkv from its recomputing forward. The f32 chain's forward does
    the same, its training forward with the fc1 product that keeps z
    (F_BIAS_GELU_Z) once a block; its backward, which takes LN1's and LN2's
    outputs, qkv, z and h from the stash, must launch neither LN forward nor
    the qkv or the fc1 product."""
    grad = bwd_fn is not None
    half_fmt = "mlp_half_f32_{}_kernel" if f32 else "mlp_half_{}_kernel"
    ln1 = "ln_f32_kernel" if f32 else "ln_fwd_kernel"  # at f32 LN2 too
    gelu_epis, epi_qkv = (GELU_EPIS_F32, EPI_QKV_F32) if f32 else (GELU_EPIS, EPI_QKV)
    xs = x.clone().requires_grad_(grad)
    ps = [[t.clone().requires_grad_(grad) for t in p] for p in params]
    res, line = {}, []
    with torch.set_grad_enabled(grad):
        out_s = split_stack(xs, ps, H)
    passes = [("fwd", fwd_fn, lambda: split_stack(xs, ps, H), half_fmt.format("fwd"))]
    if grad:
        leaves_s = [xs] + [t for p in ps for t in p]
        passes.append(("bwd", bwd_fn, lambda: torch.autograd.grad(out_s, leaves_s, dy,
                                                                    retain_graph=True),
                       half_fmt.format("bwd")))
    for pas, fn, split, half in passes:
        def ok(counts):
            epis = gemm_epis(counts, f32)
            if f32 and kind == "chain" and pas == "bwd":
                return named(counts, ln1) == 0 and not {epi_qkv, EPI_FC1_Z_F32} & set(epis)
            if f32 and kind == "chain" and epis.get(EPI_FC1_Z_F32, 0) != (N if grad else 0):
                return False
            if f32:
                return named(counts, ln1) == 2 * N and epis.get(epi_qkv) == N
            return (named(counts, half) == N and named(counts, ln1) == N
                    and not set(epis) & gelu_epis
                    and (pas == "fwd" or epis.get(epi_qkv) == N))

        with torch.set_grad_enabled(grad):
            # the larger of two sessions: a session that loses kernels reads low
            ms = max(device_ms(fn), device_ms(fn))
            split_ms = max(device_ms(split), device_ms(split))
            counts = call_launches(fn, ok)
            split_counts = call_launches(split, lambda c: True)
        res[pas] = {"device_ms": ms, "split_device_ms": split_ms,
                    "kernel_launches": sum(counts.values()),
                    "split_kernel_launches": sum(split_counts.values())}
        epis = gemm_epis(counts, f32)
        line.append(f"{pas} {ms:.3f} ms, {sum(counts.values())} launches (split pair "
                    f"{split_ms:.3f} ms, {sum(split_counts.values())}); MLP half "
                    f"{named(counts, half)}, LN{'' if f32 else '1'} {named(counts, ln1)}, "
                    f"qkv {epis.get(epi_qkv, 0)}, GELU epilogues "
                    f"{sum(epis.get(e, 0) for e in gelu_epis)}"
                    + (f" (fc1 with z {epis.get(EPI_FC1_Z_F32, 0)})" if f32 else ""))
        if not ok(counts):
            fail(f"{kind}@{geo} {pas}: launches a call {counts}")
    del out_s, xs, ps
    print(f"  {kind}@{geo}{' f32' if f32 else ''} device, per call: " + "; ".join(line),
          flush=True)
    return res


def half_bounds(L: int, D: int, f32: bool = False):
    """Per-call (fwd, bwd) bounds of the MLP half at (B, L, D), F = 4D: the
    forward reads x and writes out (bf16), 16MD^2 operations (fc1, fc2);
    the backward reads x and the f32 gradient, writes dx in bf16 and f32
    and the f32 parameter gradients, 40MD^2 operations (fc1 again, dh, dW2,
    dW1, dy2); weights (bf16) and LN params (f32) read once. With ``f32``
    every tensor is f32 (dx written once) and the operations run at the f32
    CUDA-core peak."""
    M = BATCH * L
    if f32:
        w = (8 * D * D + 7 * D) * 4
        return (bound_f32(2 * M * D * 4 + w, 16 * M * D * D),
                bound_f32(3 * M * D * 4 + 2 * w, 40 * M * D * D))
    w = 8 * D * D * 2 + 5 * D * 2 + 2 * D * 4
    fwd = bound(2 * M * D * 2 + w, 16 * M * D * D)
    bwd = bound(M * D * (2 + 4 + 2 + 4) + w + (8 * D * D + 7 * D) * 4, 40 * M * D * D)
    return fwd, bwd


def check_mlp_half(dtype=torch.bfloat16) -> dict:
    """Phase 3d, first (and at f32 phase 24 (a), first): the MLP-half
    kernels of ``csrc/block_mlp.cu`` (``csrc/block_mlp_f32.cu``) alone at
    the block geometries against ``mlp_fwd_plain`` / ``mlp_bwd_plain`` on
    the card, z rounded (the chain's) and in f32 (the whole block's; at f32
    one function): the forward within FWD_ATOL (F32_ATOL), the f32 input
    gradient and the six parameter gradients within BWD_REL (F32_BWD_REL)
    of their largest magnitudes, the rounded forward equal to the split MLP
    branch's bit for bit (at f32 also a second call's forward and backward);
    per-call CUDA-event and device times (z in f32), the plain version's
    and the bounds. The target geometry has no backward in a step."""
    f32 = dtype == torch.float32
    keys = {k: bf.dtype_key(dtype, k) for k in HALF_KERNELS}
    fk, bk = keys["mlp_half_fwd"], keys["mlp_half_bwd"]
    per = {k: {} for k in keys.values()}
    errs = dict.fromkeys(keys.values(), 0.0)
    names = ["dx", "d_ln_scale", "d_ln_bias", "d_w1", "d_b1", "d_w2", "d_b2"]
    timing = F32_TIMING if f32 else {}
    for geo, (L, D, _) in GEOMETRIES.items():
        x, dy, params = branch_inputs("mlp", L, D, seed=L + D + 1, dtype=dtype)
        gy = dy.float()
        for round_z in ((True,) if f32 else (True, False)):
            z = "f32" if f32 else "z bf16" if round_z else "z f32"
            out = bf.mlp_half(x, params, round_z)
            dx, grads = bf.mlp_half_bwd(x, params, gy, round_z)
            out_r = bf.mlp_fwd_plain(x, params, round_z)
            dx_r, grads_r = bf.mlp_bwd_plain(x, params, gy, round_z)
            fwd_err = (out.float() - out_r.float()).abs().max().item()
            atol = F32_ATOL if f32 else FWD_ATOL
            if not fwd_err <= atol:
                fail(f"mlp_half@{geo} {z} forward: max abs err {fwd_err} > {atol}")
            errs[fk] = max(errs[fk], fwd_err)
            if f32:
                again = bf.mlp_half_bwd(x, params, gy, round_z)
                if not (torch.equal(out, bf.mlp_half(x, params, round_z))
                        and all(map(torch.equal, (dx, *grads), (again[0], *again[1])))):
                    fail(f"mlp_half@{geo} f32: a second call differs")
                del again
                errs[bk] = max(errs[bk], check_close(f"mlp_half@{geo} f32", names,
                                                     (dx, *grads), (dx_r, *grads_r),
                                                     F32_BWD_REL))
            else:
                errs[bk] = max(errs[bk], check_grads(
                    f"mlp_half@{geo} {z}", names, (dx, *grads), (dx_r, *grads_r)))
            if round_z:
                with torch.no_grad():
                    if not torch.equal(out, bf.fused_mlp_branch(x, *params)):
                        fail(f"mlp_half@{geo} {z}: the forward differs from the split MLP "
                             "branch's")
            del out, dx, grads, out_r, dx_r, grads_r
        (bf_ms, bf_by), (bb_ms, bb_by) = half_bounds(L, D, f32)
        fwd = lambda: bf.mlp_half(x, params, False)  # noqa: E731
        bwd = lambda: bf.mlp_half_bwd(x, params, gy, False)  # noqa: E731
        per[fk][geo] = {
            "ms": cuda_ms(fwd, **timing), "device_ms": device_ms(fwd), "bound_ms": bf_ms,
            "bound_by": bf_by,
            "plain_ms": cuda_ms(lambda: bf.mlp_fwd_plain(x, params, False), **timing)}
        line = (f"  mlp_half@{geo} {DT_NAME[dtype]} L={L} D={D}: fwd {per[fk][geo]['ms']:.3f} "
                f"ms (device {per[fk][geo]['device_ms']:.3f}, plain "
                f"{per[fk][geo]['plain_ms']:.3f}, bound {bf_ms:.3f})")
        if f32:  # the split f32 MLP branch's forward and backward on the same data
            kp = bf._prep6(*params, dtype)
            per[fk][geo]["split_device_ms"] = device_ms(lambda: bf._mlp_fwd_cuda(x, kp))
            line += f" [split {per[fk][geo]['split_device_ms']:.3f}]"
        if geo != "tgt":
            per[bk][geo] = {
                "ms": cuda_ms(bwd, **timing), "device_ms": device_ms(bwd), "bound_ms": bb_ms,
                "bound_by": bb_by,
                "plain_ms": cuda_ms(lambda: bf.mlp_bwd_plain(x, params, gy, False), **timing)}
            r = per[bk][geo]
            line += (f", bwd {r['ms']:.3f} ms (device {r['device_ms']:.3f}, plain "
                     f"{r['plain_ms']:.3f}, bound {bb_ms:.3f})")
            if f32:
                r["split_device_ms"] = device_ms(lambda: bf._mlp_bwd_cuda(x, kp, gy))
                line += f" [split {r['split_device_ms']:.3f}]"
        print(line, flush=True)
        del x, dy, params, gy
        torch.cuda.empty_cache()
    return {k: summarize(per[k], errs[k], STEP_CALLS) for k in keys.values()}


def check_stack(kind: str, dtype=torch.bfloat16) -> dict:
    """Phases 3d (``kind="block"``: one block per geometry) and 3e
    (``"chain"``: CHAIN_DEPTH blocks), and at f32 phase 24 (a): the kernels
    against their plain versions, every backward output, and per-call
    times, with each pass's device time and launches beside the split
    kernels' (``stack_device``); the target geometry runs the no-grad
    forward only. At f32 the chain runs at F32_CHAIN_GEOS, the forward is
    held to F32_ATOL and each backward output to F32_BWD_REL, both kinds'
    forwards equal the f32 split kernels' bit for bit (one function at f32),
    a second backward gives the first's bits, and the chain's backward (from
    its stash, running neither the qkv nor the fc1 product) gives the split
    f32 pair's gradients (rows 2 + 5 through autograd) bit for bit."""
    f32 = dtype == torch.float32
    names = [bf.dtype_key(dtype, k)
             for k in (BLOCK_KERNELS if kind == "block" else CHAIN_KERNELS)]
    fwd, nograd, bwd = names
    per = {k: {} for k in names}
    errs = dict.fromkeys(names, 0.0)
    timing = F32_TIMING if f32 else {}
    geos = [g for g in GEOMETRIES if not (f32 and kind == "chain") or g in F32_CHAIN_GEOS]
    for geo in geos:
        L, D, H = GEOMETRIES[geo]
        grad = geo != "tgt"
        N = 1 if kind == "block" else CHAIN_DEPTH[geo]
        x, dy, params = stack_inputs(L, D, N, seed=L + D + N, dtype=dtype)
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
            if kind == "chain" or f32:
                split = x
                for p in params:
                    split = bf.fused_mlp_branch(bf.fused_attn_branch(split, *p[:6], H), *p[6:])
        torch.cuda.synchronize()
        if not torch.equal(out_ng, out_k):
            fail(f"{kind}@{geo}: the no-grad forward differs from the forward")
        if split is not None and not torch.equal(split, out_k):
            fail(f"{kind}@{geo} {DT_NAME[dtype]}: the forward differs from the split kernels'")
        fwd_err = (out_k.float() - out_r.float()).abs().max().item()
        # bf16: a rounding flipped in one block carries on
        atol = F32_ATOL if f32 else FWD_ATOL * N
        if not fwd_err <= atol:
            fail(f"{kind}@{geo} {DT_NAME[dtype]} forward: max abs err {fwd_err} > {atol}")
        (bf_ms, bf_by), (bb_ms, bb_by) = stack_bounds(L, D, N, stash=kind == "chain" and grad,
                                                      f32=f32)
        with torch.no_grad():
            t_plain = cuda_ms(lambda: ref(x, params), **timing)
            t_ng = cuda_ms(lambda: kern(x, params), **timing)
        t_fwd = cuda_ms(lambda: kern(xl, pl), **timing) if grad else t_ng
        key = fwd if grad else nograd
        per[key][geo] = {"ms": t_fwd, "plain_ms": t_plain, "bound_ms": bf_ms, "bound_by": bf_by}
        errs[key] = max(errs[key], fwd_err)
        dev = stack_device(
            kind, geo, N, (lambda: kern(xl, pl)) if grad else (lambda: kern(x, params)),
            (lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True))
            if grad else None, x, dy, params, H, f32)
        per[key][geo].update(dev["fwd"])
        line = (f"  {kind}@{geo} {DT_NAME[dtype]} L={L} D={D} N={N}: fwd {t_fwd:.3f} ms (plain "
                f"{t_plain:.3f}, bound {bf_ms:.3f})")
        if grad:
            grads_k = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
            out_rg = ref(xl, pl)
            grads_r = torch.autograd.grad(out_rg, leaves, dy, retain_graph=True)
            gnames = ["dx"] + [f"d{i // 12}_{i % 12}" for i in range(12 * N)]
            if f32:
                again = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
                if not all(map(torch.equal, grads_k, again)):
                    fail(f"{kind}@{geo} f32: a second backward differs from the first")
                del again
                if kind == "chain":
                    xs = x.clone().requires_grad_()
                    ps = [[t.clone().requires_grad_() for t in p] for p in params]
                    grads_s = torch.autograd.grad(split_stack(xs, ps, H),
                                                  [xs] + [t for p in ps for t in p], dy)
                    differ = [n for n, a, b in zip(gnames, grads_k, grads_s)
                              if not torch.equal(a, b)]
                    if differ:
                        fail(f"chain@{geo} f32: the backward differs from the split f32 "
                             f"pair's in {differ}")
                    print(f"  chain@{geo} f32: the backward from the stash equals the split "
                          f"f32 pair's bit for bit ({len(gnames)} outputs)", flush=True)
                    del xs, ps, grads_s
                bwd_err = check_close(f"{kind}@{geo} f32", gnames, grads_k, grads_r,
                                      F32_BWD_REL)
            else:
                bwd_err = check_grads(f"{kind}@{geo}", gnames, grads_k, grads_r)
            t_bwd = cuda_ms(lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True),
                            **timing)
            t_pbwd = cuda_ms(lambda: torch.autograd.grad(out_rg, leaves, dy, retain_graph=True),
                             **timing)
            per[bwd][geo] = {"ms": t_bwd, "plain_ms": t_pbwd, "bound_ms": bb_ms,
                             "bound_by": bb_by, **dev["bwd"]}
            errs[bwd] = max(errs[bwd], bwd_err)
            line += (f", bwd {t_bwd:.3f} ms (plain {t_pbwd:.3f}, bound {bb_ms:.3f}); bwd max "
                     f"abs err {bwd_err:.3e}")
            del grads_k, grads_r, out_rg
        else:
            line += f" (no-grad; with grad {cuda_ms(lambda: kern(xl, pl), **timing):.3f})"
        print(line + f"; fwd max abs err {fwd_err:.3e}", flush=True)
        del out_k, out_r, out_ng, split, xl, pl, leaves
        torch.cuda.empty_cache()
    calls = STEP_CALLS if kind == "block" else CHAIN_CALLS
    return {k: summarize(per[k], errs[k], calls) for k in names}


def attention_inputs(entry: str, L: int, D: int, H: int, seed: int, batch: int = BATCH,
                     dtype=torch.bfloat16):
    """Unit-normal leaves (bf16, or ``dtype``) of the entry's layout, and dO,
    on the card."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(batch, L, D, generator=g).to(dtype).cuda() for _ in range(4))
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


def mha_occupancy(f32: bool = False) -> None:
    """Phases 3b and 23 (a): blocks per SM of the attention kernels (``f32``:
    of ``csrc/mha_f32.cu``) at the decoder's and the encoder's head geometry
    (at f32 also the predictor's and the target encoder's), from the CUDA
    occupancy calculator."""
    lib = _build.load()
    fn, name = ((lib.ssrl_mha_f32_occupancy, "mha_f32") if f32
                else (lib.ssrl_mha_occupancy, "mha"))
    geos = ((145, 32), (37, 24), (145, 16), (145, 24)) if f32 else ((145, 32), (37, 24))
    for L, d in geos:
        for pas in ("fwd", "bwd"):
            vals = [ctypes.c_int() for _ in range(4)]
            _build.check(fn(L, d, int(pas == "bwd"), *(ctypes.byref(v) for v in vals)),
                         f"{name}_occupancy")
            blocks, warps, smem, regs = (v.value for v in vals)
            print(f"  {name} {pas} at L={L}, d={d}: {blocks} blocks of {warps} warps per SM "
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


def embed_inputs(K, seed: int, dtype=torch.bfloat16):
    """Patches (bf16, or ``dtype``), f32 embedding params and dy at the
    flagship geometry, on the card; the index holds CLS first and K - 1
    distinct patch tokens per image, unsorted (the JEPA context's argsort
    order)."""
    g = torch.Generator().manual_seed(seed)
    N, Pc, D = EMBED_N, EMBED_PC, EMBED_D
    patches = (torch.rand(BATCH, N, Pc, generator=g) * 2 - 1).to(dtype)
    params = [torch.randn(D, Pc, generator=g) * Pc**-0.5, 0.02 * torch.randn(D, generator=g),
              0.02 * torch.randn(1, 1, D, generator=g), 0.02 * torch.randn(1, N + 1, D, generator=g)]
    idx = None
    if K is not None:
        perm = torch.argsort(torch.rand(BATCH, N, generator=g), dim=-1)[:, :K - 1] + 1
        idx = torch.cat([torch.zeros(BATCH, 1, dtype=torch.long), perm], dim=1).cuda()
    dy = torch.randn(BATCH, N + 1 if K is None else K, D, generator=g).to(dtype)
    return patches.cuda(), [p.cuda() for p in params], idx, dy.cuda()


def embed_bounds(K, f32: bool = False):
    """Per-call bounds of the embed kernels: (fwd, bwd without dpatches, bwd
    with dpatches). The kept non-CLS rows of the patches are read once, the
    (B, K, D) output or dy once, the bf16 (``f32``: f32) weight and bias, the
    f32 CLS and position rows and the int64 index once; f32 dW, db and
    d(cls_pos) written once (dpatches in full: zeros outside the kept rows).
    Operations: 2·rows·Pc·D per product (forward; dW; dpatches), with
    ``f32`` at the f32 CUDA-core peak."""
    N, Pc, D = EMBED_N, EMBED_PC, EMBED_D
    L = N + 1
    e = 4 if f32 else 2
    bnd = bound_f32 if f32 else bound
    k = L if K is None else K
    rows = BATCH * (k - 1)  # kept rows that are patches (CLS is not)
    idx = 0 if K is None else BATCH * k * 8
    gemm = 2 * rows * Pc * D
    fwd = bnd(rows * Pc * e + BATCH * k * D * e + D * Pc * e + D * e + L * D * 4 + idx, gemm)
    grads_out = D * Pc * 4 + D * 4 + L * D * 4
    bwd = bnd(BATCH * k * D * e + rows * Pc * e + idx + grads_out, gemm)
    bwd_dp = bnd(BATCH * k * D * e + rows * Pc * e + D * Pc * e + idx + grads_out
                 + BATCH * N * Pc * e, 2 * gemm)
    return fwd, bwd, bwd_dp


def check_embed(dtype=torch.bfloat16) -> dict:
    """Phase 3c (bf16) and 24 (a) (f32): the embed kernels against the plain
    version at the three index forms, every output of the backward, and
    per-call times; at f32 the forward within F32_ATOL and each backward
    output within F32_BWD_REL."""
    f32 = dtype == torch.float32
    fwd_key, bwd_key = (bf.dtype_key(dtype, k) for k in EMBED_KERNELS)
    per = {"fwd": {}, "bwd": {}}
    err = {"fwd": 0.0, "bwd": 0.0}
    for geo, K in EMBED_GEOS.items():
        patches, params, idx, dy = embed_inputs(K, seed=7 + (K or 0), dtype=dtype)
        leaves = [p.clone().requires_grad_() for p in params]
        before = dict(ef.LAUNCHES)
        out_k = ef.fused_patch_embed(patches, *leaves, idx)
        grads_k = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
        if ef.LAUNCHES != {**before, fwd_key: before[fwd_key] + 1,
                           bwd_key: before[bwd_key] + 1}:
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
        if f32:
            out_2 = ef.fused_patch_embed(pl, *leaves, idx)
            grads_2 = torch.autograd.grad(out_2, [pl] + leaves, dy)
            if not (torch.equal(out_2, out_kp) and all(map(torch.equal, grads_2, grads_kp))):
                fail(f"embed@{geo} f32: a second forward and backward differ in their bits")
            del out_2, grads_2
        fwd_err = (out_k.float() - out_r.float()).abs().max().item()
        atol = F32_ATOL if f32 else FWD_ATOL
        if not fwd_err <= atol:
            fail(f"embed@{geo} {DT_NAME[dtype]} forward: max abs err {fwd_err} > {atol}")
        gnames = ["dpatches", "dw", "db", "dcls", "dpos"]
        if f32:
            bwd_err = check_close(f"embed@{geo} f32", gnames, grads_kp, grads_r, F32_BWD_REL)
        else:
            bwd_err = check_grads(f"embed@{geo}", gnames, grads_kp, grads_r)
        # the yardstick: a gather of the kept patch rows, then torch.matmul
        wb = params[0].to(dtype)
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
        (bf_ms, bf_by), (bb_ms, bb_by), (bd_ms, _) = embed_bounds(K, f32)
        per["fwd"][geo] = {**t_fwd, "bound_ms": bf_ms, "bound_by": bf_by}
        per["bwd"][geo] = {**t_bwd, "bound_ms": bb_ms, "bound_by": bb_by,
                           "ms_dpatches": t_dp, "bound_ms_dpatches": bd_ms}
        err["fwd"], err["bwd"] = max(err["fwd"], fwd_err), max(err["bwd"], bwd_err)
        print(f"  embed@{geo} {DT_NAME[dtype]} K={K}: fwd {t_fwd['ms']:.3f} ms (plain "
              f"{t_fwd['plain_ms']:.3f}, "
              f"gather+matmul {t_fwd['library_ms']:.3f}, bound {bf_ms:.4f}), bwd "
              f"{t_bwd['ms']:.3f} ms (plain {t_bwd['plain_ms']:.3f}, gather+matmul "
              f"{t_lib_bwd:.3f}, bound {bb_ms:.4f}), bwd with dpatches {t_dp:.3f} ms "
              f"(bound {bd_ms:.4f}); device fwd {t_fwd['device_ms']:.4f} (gather+matmul "
              f"{t_fwd['library_device_ms']:.4f}), bwd {t_bwd['device_ms']:.4f} "
              f"(gather+matmul {t_bwd['library_device_ms']:.4f}); max abs err fwd "
              f"{fwd_err:.3e}, bwd {bwd_err:.3e}", flush=True)
        print(f"    device fwd by kernel: {kernel_shares(fwd_shares)}")
        print(f"    device bwd by kernel: {kernel_shares(bwd_shares)}", flush=True)
        del out_k, out_kp, out_r, out_rn, grads_k, grads_kp, grads_r
    if f32:
        embed_f32_edges()
    res = {}
    for pas in ("fwd", "bwd"):
        r = summarize(per[pas], err[pas], EMBED_CALLS[pas])
        for g, v in per[pas].items():
            r.update({f"{k}_{g}": x for k, x in v.items() if k.endswith("dpatches")})
        res[bf.dtype_key(dtype, f"patch_embed_{pas}")] = r
    return res


def embed_f32_edges() -> None:
    """Phase 24 (a): the f32 embed at B=768 and the flagship widths at the
    edges of its index forms: K=1, K=L with an index (every token,
    permuted), repeated indices and indices out of range (a NaN row and no
    gradient: held to the plain version on the valid index with those dy
    rows zeroed); every output within the f32 bounds, dpatches included,
    and a second call the same bits."""
    g = torch.Generator().manual_seed(11)
    L = EMBED_N + 1
    bad = torch.randint(1, L, (BATCH, 8), generator=g)
    cases = {"k1": torch.randint(0, L, (BATCH, 1), generator=g),
             "kL_index": torch.argsort(torch.rand(BATCH, L, generator=g), dim=-1),
             "repeats": torch.randint(0, L, (BATCH, 45), generator=g),
             "out_of_range": bad}
    for name, idx in cases.items():
        idx = idx.cuda()
        patches, params, _, _ = embed_inputs(37, seed=13, dtype=torch.float32)
        dy = torch.randn(BATCH, idx.shape[1], EMBED_D, generator=g).cuda()
        kidx, ridx, rdy = idx, idx, dy
        if name == "out_of_range":
            kidx = idx.clone()
            kidx[:, 3] = L
            kidx[0, 5] = -1
            rdy = dy.clone()
            rdy[:, 3] = 0
            rdy[0, 5] = 0
        leaves = [patches.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
        runs = []
        for _ in range(2):
            out = ef.fused_patch_embed(*leaves, kidx)
            runs.append((out, torch.autograd.grad(out, leaves, dy)))
        (out_k, grads_k), (out_2, grads_2) = runs
        out_r = ef.fused_patch_embed_ref(*leaves, ridx)
        grads_r = torch.autograd.grad(out_r, leaves, rdy)
        torch.cuda.synchronize()
        what = f"embed f32 {name} (K={idx.shape[1]})"
        bits = (out_2.view(torch.int32), out_k.view(torch.int32))  # NaN rows compare too
        if not (torch.equal(*bits) and all(map(torch.equal, grads_2, grads_k))):
            fail(f"{what}: a second call differs in its bits")
        keep = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        if name == "out_of_range":
            keep[:, 3] = False
            keep[0, 5] = False
            if not (torch.isnan(out_k[:, 3]).all() and torch.isnan(out_k[0, 5]).all()):
                fail(f"{what}: an index out of range did not give a NaN row")
        fwd_err = (out_k[keep] - out_r[keep]).abs().max().item()
        if not fwd_err <= F32_ATOL:
            fail(f"{what} forward: max abs err {fwd_err} > {F32_ATOL}")
        bwd_err = check_close(what, ["dpatches", "dw", "db", "dcls", "dpos"], grads_k, grads_r,
                              F32_BWD_REL)
        print(f"  {what}: max abs err fwd {fwd_err:.3e}, bwd {bwd_err:.3e}; two calls the "
              "same bits", flush=True)


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
    chains), with the fused embed one of each more; block and chain launch
    the MLP-half kernels once a block each way."""
    names = ["attn_branch_fwd", "attn_branch_bwd", "mlp_branch_fwd", "mlp_branch_bwd"]
    if impl == "chain":
        names = ["chain_fwd", "chain_bwd"]
    elif impl == "block":
        names = ["block_fwd", "block_bwd"]
    elif impl != "auto":
        names = [f"{IMPL_ENTRY[impl]}_{pas}" for pas in ("fwd", "bwd")]
    blocks = sum(STEP_CALLS["mae"].values())
    want = dict.fromkeys(names, len(CHAIN_CALLS["mae"]) if impl == "chain" else blocks)
    if impl in ("block", "chain"):
        want.update(mlp_half_fwd=blocks, mlp_half_bwd=blocks)
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
    if impl in ("block", "chain"):
        want.update(mlp_half_fwd=grad + c["tgt"], mlp_half_bwd=grad)
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


def timed_steps(task, state, batch, name: str, what: str, device: bool = False):
    """WARMUP steps, then STEPS steps between zeroed and read launch counts
    (with ``device``, then the step's device time under the profiler);
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
    print(f"  {what} B={BATCH} {DT_NAME[task.model.dtype]} on {name}: {ms:.3f} ms/step "
          f"(CUDA events), "
          f"{BATCH / ms * 1e3:.1f} img/s; wall {wall / STEPS * 1e3:.3f} ms/step; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    losses = [float(s["loss_sum"]) / BATCH for s in sums]
    print(f"  losses: {[round(v, 5) for v in losses]}")
    print(f"  launches over {STEPS} steps: {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: non-finite loss: {losses}")
    if device:
        dev = device_ms(lambda: task.train_step(state, batch, 0, ctx), iters=3)
        print(f"  {what}: {dev:.3f} device ms/step (torch.profiler, 3 steps)", flush=True)
    return state, sums, launches, ms


def check_moved(before: dict, after: dict, what: str) -> None:
    moved = sum(int(not torch.equal(before[k], v)) for k, v in after.items())
    if moved != len(before):
        fail(f"{what}: only {moved} of {len(before)} tensors changed")


def mae_step(model_cfg: dict, name: str, impl: str, fused: bool = False,
             pre_cfg: dict = PRE_CFG, route: str = "", dtype=torch.bfloat16):
    """Phases 4, 6, 7, 9, 11, 12, 19, 23: the flagship step through MAETask
    on the card (``route`` names a lineage route of phase 19); returns its
    launches and ms/step."""
    with fused_embed(fused):
        task = MAETask(model_cfg, pre_cfg, dtype=dtype, device="cuda", attn_impl=impl)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        what = (f"MAE step attn_impl={impl}" + (" SSRL_FUSED_EMBED=1" if fused else "")
                + (f" {route}" if route else ""))
        state, _, launches, ms = timed_steps(task, state, flagship_images(), name, what,
                                             device=dtype == torch.float32)
    check_moved(before, state.params, what)
    want = expected(launch_names(mae_launches(impl, fused), dtype), STEPS)
    if launches != want:
        fail(f"{what}: launches in {STEPS} steps {launches}, expected {want}")
    del task, state
    torch.cuda.empty_cache()
    return launches, ms


def on_cpu(draws: tuple) -> tuple:
    """The draws on the CPU (None, the augmentation's when it is off, stays)."""
    return tuple(None if d is None else d.cpu() for d in draws)


def check_step_grads(what: str, gpu, gs, gbatch: dict, cpu, cs, cbatch: dict, draws: tuple,
                     ctx=None, rel: float = STEP_GRAD_REL) -> None:
    """One step's trainable gradients, kernels on the card against the plain
    path on the CPU from the same weights and draws, before the step updates
    the params: each within ``rel`` of the CPU tensor's largest magnitude."""
    names, g_gpu, _ = gpu.gradients(gs, gbatch, ctx, draws)
    names_cpu, g_cpu, _ = cpu.gradients(cs, cbatch, ctx, on_cpu(draws))
    if names != names_cpu:
        fail(f"{what}: the card trains {len(names)} tensors, the CPU {len(names_cpu)}")
    worst, worst_name = 0.0, ""
    for k, a, b in zip(names, g_gpu, g_cpu):
        err = (a.float().cpu() - b.float()).abs().max().item()
        lim = rel * b.float().abs().max().item() + 1e-6
        if err / lim > worst:
            worst, worst_name = err / lim, k
        if not err <= lim:
            fail(f"{what} gradient {k}: card vs CPU max abs err {err:.3e} > {lim:.3e}")
    print(f"  {what}: {len(names)} trainable gradients, card vs CPU, the worst at "
          f"{worst:.3f} of its bound ({worst_name}; bound {rel:g} of each CPU "
          f"tensor's largest magnitude)")


def cpu_agreement(model_cfg: dict, impl: str, pre_cfg: dict = PRE_CFG, route: str = "",
                  dtype=torch.bfloat16) -> None:
    """Phases 5-7, 11, 12, 19, 23, 24: B=16, same weights and draws, kernels
    vs plain CPU path (under the caller's ``SSRL_FUSED_EMBED``)."""
    n = 16
    fused = ef.use_fused_embed()
    loss_rtol, grad_rel = step_tolerances(dtype)
    gpu = MAETask(model_cfg, pre_cfg, dtype=dtype, device="cuda", attn_impl=impl)
    cpu = MAETask(model_cfg, pre_cfg, dtype=dtype, device="cpu", attn_impl=impl)
    gs, cs = gpu.init_state(1), cpu.init_state(1)
    cpu.model.load_state_dict(gpu.model.state_dict())
    images = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)
    )
    ctx = gpu.epoch_context(0)
    draws = gpu.draw(gs.generator, n, ctx)
    weight = torch.ones(n)
    what = (f"attn_impl={impl} {route} B={n} {DT_NAME[dtype]}"
            + (" SSRL_FUSED_EMBED=1" if fused else ""))
    check_step_grads(what, gpu, gs, {"image": images.cuda(), "weight": weight.cuda()},
                     cpu, cs, {"image": images, "weight": weight}, draws, ctx, grad_rel)
    reset_counts()
    _, s_gpu = gpu.train_step(gs, {"image": images.cuda(), "weight": weight.cuda()},
                              0, ctx, draws)
    launched = launch_counts()
    _, s_cpu = cpu.train_step(cs, {"image": images, "weight": weight}, 0, ctx,
                              on_cpu(draws))
    if launch_counts() != launched or launched != expected(
            launch_names(mae_launches(impl, fused), dtype)):
        fail(f"launch counts: {launch_counts()} (the GPU step must launch one of each "
             f"kernel of attn_impl={impl} per block, the CPU step none)")
    lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
    print(f"  {what} loss: kernels on the card {lg:.7f}, plain on the CPU {lc:.7f}")
    if not abs(lg - lc) <= loss_rtol * abs(lc):
        fail(f"loss disagrees: {lg} vs {lc} (rtol {loss_rtol})")


def jepa_step(model_cfg: dict, jepa_cfg: dict, name: str, fused: bool,
              impl: str = "auto", route: str = "", dtype=torch.bfloat16):
    """Phases 8, 9, 13, 14, 19, 23: the flagship JEPA step through JEPATask
    on the card; returns its launches and ms/step."""
    what = (f"JEPA step attn_impl={impl}" + (" SSRL_FUSED_EMBED=1" if fused else "")
            + (f" {route}" if route else ""))
    with fused_embed(fused):
        task = JEPATask(model_cfg, jepa_cfg, dtype=dtype, device="cuda", attn_impl=impl)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        extra0 = {k: v.clone() for k, v in state.extra.items()}
        state, sums, launches, ms = timed_steps(task, state, flagship_images(), name, what,
                                                device=dtype == torch.float32)
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
    want = expected(launch_names(jepa_launches(fused, impl), dtype), STEPS)
    if launches != want:
        fail(f"{what}: launches in {STEPS} steps {launches}, expected {want}")
    del task, state
    torch.cuda.empty_cache()
    return launches, ms


def jepa_cpu_agreement(model_cfg: dict, jepa_cfg: dict, impl: str = "auto",
                       route: str = "", dtype=torch.bfloat16) -> None:
    """Phases 10, 13, 14, 19, 23, 24: B=16, same weights, EMA and draws,
    kernels vs plain CPU (under the caller's ``SSRL_FUSED_EMBED``)."""
    n = 16
    fused = ef.use_fused_embed()
    loss_rtol, grad_rel = step_tolerances(dtype)
    gpu = JEPATask(model_cfg, jepa_cfg, dtype=dtype, device="cuda", attn_impl=impl)
    cpu = JEPATask(model_cfg, jepa_cfg, dtype=dtype, device="cpu", attn_impl=impl)
    gs, cs = gpu.init_state(1), cpu.init_state(1)
    cpu.model.load_state_dict(gpu.model.state_dict())
    cs.extra = {k: v.cpu().clone() for k, v in gs.extra.items()}
    images = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (n, 96, 96, 3)).astype(np.uint8))
    draws = gpu.draw(gs.generator, n, None)
    weight = torch.ones(n)
    what = (f"JEPA attn_impl={impl} {route} B={n} {DT_NAME[dtype]}"
            + (" SSRL_FUSED_EMBED=1" if fused else ""))
    check_step_grads(what, gpu, gs, {"image": images.cuda(), "weight": weight.cuda()},
                     cpu, cs, {"image": images, "weight": weight}, draws, rel=grad_rel)
    reset_counts()
    _, s_gpu = gpu.train_step(gs, {"image": images.cuda(), "weight": weight.cuda()},
                              0, None, draws)
    launched = launch_counts()
    _, s_cpu = cpu.train_step(cs, {"image": images, "weight": weight}, 0, None,
                              on_cpu(draws))
    want = launch_names(jepa_launches(fused, impl), dtype)
    if launch_counts() != launched or launched != expected(want):
        fail(f"launch counts: {launch_counts()} (the GPU JEPA step must launch "
             f"{want}, the CPU step nothing)")
    lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
    print(f"  {what} loss: kernels on the card {lg:.7f}, plain on the CPU {lc:.7f}")
    if not abs(lg - lc) <= loss_rtol * abs(lc):
        fail(f"JEPA loss disagrees: {lg} vs {lc} (rtol {loss_rtol})")


def classifier_task(model_cfg: dict, train_cfg: dict, policy: str, device: str,
                    impl: str = "auto", augment: bool = True, dtype=torch.bfloat16):
    """``ClassifierTask`` on the configuration's train section, at ``dtype``,
    under one freeze policy of ``FREEZE``."""
    task = ClassifierTask(model_cfg, train_cfg, dtype=dtype, device=device,
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
                     augment: bool = True, dtype=torch.bfloat16, impl: str = "auto"):
    """Phases 15, 19, 23 and 24: the flagship classifier step through
    ``ClassifierTask`` on ``impl`` under each of ``policies``, then
    (augmentation on) its eval step; exact launches per step (under the
    caller's ``SSRL_FUSED_EMBED``). Returns the launches and the ms/step of
    each policy."""
    fused = ef.use_fused_embed()
    launches = dict.fromkeys(launch_counts(), 0)
    step_ms = {}
    batch = flagship_images()
    for policy in policies:
        task = classifier_task(model_cfg, train_cfg, policy, "cuda", impl=impl, augment=augment,
                               dtype=dtype)
        state = task.init_state(0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        what = (f"classifier step {policy}" + ("" if augment else " augment off")
                + ("" if impl == "auto" else f" attn_impl={impl}")
                + (" SSRL_FUSED_EMBED=1" if fused else ""))
        state, sums, got, step_ms[policy] = timed_steps(task, state, batch, name, what,
                                                        device=dtype == torch.float32)
        check_frozen(task, before, state.params, what)
        want = expected(launch_names(cls_launches(policy, impl, fused), dtype), STEPS)
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
            print(f"  classifier eval step B={BATCH} {DT_NAME[dtype]} on {name}: {ms:.3f} "
                  f"ms/step (CUDA events), {BATCH / ms * 1e3:.1f} img/s; {m}", flush=True)
            want = expected(launch_names(cls_launches("eval", impl, fused), dtype), STEPS)
            if got != want:
                fail(f"classifier eval: launches in {STEPS} steps {got}, expected {want}")
            if not all(math.isfinite(v) for v in m.values()):
                fail(f"classifier eval: {m}")
            for k, v in got.items():
                launches[k] += v
        del task, state
        torch.cuda.empty_cache()
    return launches, step_ms


def classifier_cpu_agreement(model_cfg: dict, train_cfg: dict, policies=tuple(FREEZE),
                             augment: bool = True, dtype=torch.bfloat16,
                             impl: str = "auto") -> None:
    """Phases 16, 19, 23 and 24: B=16, same weights and draws, kernels on the
    card against the plain path on the CPU, on ``impl`` under each of
    ``policies`` (the loss, every trainable gradient, the frozen tensors'
    bits); then (augmentation on) the eval step's sums; under the caller's
    ``SSRL_FUSED_EMBED``."""
    n = 16
    fused = ef.use_fused_embed()
    loss_rtol, grad_rel = step_tolerances(dtype)
    for policy in policies:
        gpu = classifier_task(model_cfg, train_cfg, policy, "cuda", impl=impl, augment=augment,
                              dtype=dtype)
        cpu = classifier_task(model_cfg, train_cfg, policy, "cpu", impl=impl, augment=augment,
                              dtype=dtype)
        gs, cs = gpu.init_state(1), cpu.init_state(1)
        cpu.model.load_state_dict(gpu.model.state_dict())
        batch = flagship_images(1, n, "cpu")
        if policy == "full" and augment:
            reset_counts()
            eg = gpu.eval_step(gs, {k: v.cuda() for k, v in batch.items()}, None)
            launched = launch_counts()
            ec = cpu.eval_step(cs, batch, None)
            want = launch_names(cls_launches("eval", impl, fused), dtype)
            if launch_counts() != launched or launched != expected(want):
                fail(f"classifier eval launch counts: {launch_counts()}")
            print(f"  eval B={n}: card {({k: round(float(v), 5) for k, v in eg.items()})}, "
                  f"CPU {({k: round(float(v), 5) for k, v in ec.items()})}")
            if not abs(float(eg["acc_sum"]) - float(ec["acc_sum"])) <= 1.0:
                fail(f"eval acc_sum disagrees: {float(eg['acc_sum'])} vs {float(ec['acc_sum'])}")
            lg, lc = float(eg["loss_sum"]), float(ec["loss_sum"])
            if not abs(lg - lc) <= loss_rtol * abs(lc):
                fail(f"eval loss_sum disagrees: {lg} vs {lc} (rtol {loss_rtol})")
        draws = gpu.draw(gs.generator, n, None)
        before = {k: v.detach().clone() for k, v in cs.params.items()}
        check_step_grads(f"classifier {policy} {impl} {DT_NAME[dtype]}", gpu, gs,
                         {k: v.cuda() for k, v in batch.items()}, cpu, cs, batch, draws,
                         rel=grad_rel)
        reset_counts()
        _, s_gpu = gpu.train_step(gs, {k: v.cuda() for k, v in batch.items()}, 0, None, draws)
        launched = launch_counts()
        _, s_cpu = cpu.train_step(cs, batch, 0, None, on_cpu(draws))
        want = launch_names(cls_launches(policy, impl, fused), dtype)
        if launch_counts() != launched or launched != expected(want):
            fail(f"classifier {policy} launch counts: {launch_counts()}, expected "
                 f"{want} on the card and nothing on the CPU")
        lg, lc = float(s_gpu["loss_sum"]) / n, float(s_cpu["loss_sum"]) / n
        print(f"  classifier {policy} B={n} {DT_NAME[dtype]} loss: kernels on the card "
              f"{lg:.7f}, plain on the CPU {lc:.7f}")
        if not abs(lg - lc) <= loss_rtol * abs(lc):
            fail(f"classifier {policy} loss disagrees: {lg} vs {lc} (rtol {loss_rtol})")
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


# phase 23: f32 training on the card. Rows 1, 2 and 5 at f32
# (csrc/branch_f32.cu; row 4 at f32 is phase 3f's kernel, which the f32 step
# runs with a gradient too) and rows 8-11 at f32 (csrc/mha_f32.cu): key ->
# (branch, TPU kernel)
F32_TRAIN_KERNELS = {
    "attn_branch_fwd_f32": ("attn", _TPU + "block_pallas.py:722"),
    "attn_branch_bwd_f32": ("attn", _TPU + "block_pallas.py:752"),
    "mlp_branch_bwd_f32": ("mlp", _TPU + "block_pallas.py:831"),
}
# (B, L, D, H) checked beyond the model's geometries, correctness only: the
# rest of tests/test_torch_cuda.py's SHAPES (head dim 12 with ragged L, L=160
# at d=32) and of its ATTN_SHAPES (ragged L at every head dim up to 32)
F32_ODD_SHAPES = ((3, 17, 48, 4), (2, 160, 64, 2))
F32_ATTN_ODD = ((3, 17, 48, 4), (2, 23, 16, 2), (2, 160, 64, 2), (2, 176, 32, 2),
                (2, 256, 64, 2)) + tuple((3, L, 2 * d, 2) for L in (1, 15, 16, 17, 33, 48, 144)
                                         for d in (8, 16, 24, 32))
F32_TIMING = {"iters": 5, "warmup": 2}  # the f32 kernels take ms a call at B=768
F32_FUSED_N = 3  # phase 23 (f): replayed and eager MAE steps at f32
F32_FIT_BATCH = 256  # phase 23 (e): 15 steps in the epoch of 3760 images
# phase 24 (a): the f32 chain at the MAE encoder and decoder stacks and the
# JEPA target encoder's (no-grad); the whole block at every GEOMETRIES entry
F32_CHAIN_GEOS = ("enc", "dec", "tgt")
# phase 24: the f32 kernels of rows 6, 7 and 12 (bf16 key -> source file)
F32_STACK_SOURCES = {**dict.fromkeys(BLOCK_KERNELS, "fused_block_f32.cu"),
                     **dict.fromkeys(CHAIN_KERNELS, "block_chain_f32.cu"),
                     **dict.fromkeys(EMBED_KERNELS, "patch_embed_f32.cu")}


@contextlib.contextmanager
def no_tf32():
    """Both TF32 switches off inside the block (an f32 product or convolution
    in TF32 keeps three digits), restored after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off for matmul and cuDNN (was "
          f"{was[0]} / {was[1]}; restored after the phase)", flush=True)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def f32_grad_bounds(kind: str, B: int, L: int, D: int):
    """Per-call (stash forward, backward) bounds of an f32 branch at (B, L,
    D), F = 4D: f32 activations read and written once (the stash forward
    writes ``a`` too; the backward reads x, dy and ``a`` and writes dx), the
    weights read and their gradients written once; the operations of
    ``branch_bounds`` at the f32 CUDA-core peak."""
    M, att = B * L, B * L * L * D
    act = M * D * 4
    if kind == "attn":
        w = (4 * D * D + 6 * D) * 4
        return (bound_f32(3 * act + w, 8 * M * D * D + 4 * att),
                bound_f32(4 * act + 2 * w, 22 * M * D * D + 10 * att))
    w = (8 * D * D + 7 * D) * 4
    return bound_f32(2 * act + w, 16 * M * D * D), bound_f32(3 * act + 2 * w, 40 * M * D * D)


def check_close(what: str, names, got, want, rel: float) -> float:
    """Each tensor within ``rel`` of its plain twin's largest magnitude
    (+1e-6); returns the largest error."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        err = (a - b).abs().max().item()
        lim = rel * b.abs().max().item() + 1e-6
        if not err <= lim:
            fail(f"{what} {name}: max abs err {err:.3e} > {lim:.3e}")
        worst = max(worst, err)
    return worst


# the f32 per-product table (phase 23 (a)): the geometries timed (the JEPA
# target encoder's forward products are the classifier's, "cls", at the
# same shape) and the f32 GEMM's kernels by name
F32_GEMM_GEOS = ("enc", "dec", "ctx", "pred", "cls")
F32_GEMM_STEPS = {"mae": {"enc": 4, "dec": 2}, "jepa": {"ctx": 4, "pred": 2, "cls": 4},
                  "classifier": {"cls": 4}}


def gemm_f32_bound(layout: str, epi: str, M: int, N: int, K: int):
    """Least time of one f32 product: A and B read once, C written once, the
    epilogue's extra f32 tensor read (residual, pre-activation) or written
    (pre-activation) once, all f32; 2MNK operations at the f32 CUDA-core
    peak."""
    extra = M * N if epi in ("bias_resid", "bias_gelu", "gelu_bwd") else 0
    return bound_f32(4 * (M * K + K * N + M * N + extra), 2 * M * N * K)


def gemm_f32_table() -> list:
    """Phase 23 (a)'s f32 per-product table, TF32 off: every product of rows
    1-5 at f32 (``gemm_products`` read at f32) at the main paths' shapes
    through ``bf.gemm`` on f32 operands, held to ``gemm_ref`` at f32 (the
    forward products within F32_ATOL on unit-scale operands, the gradient
    products within F32_BWD_REL of the plain output's largest magnitude),
    a second call the same bits; under one profiler session each, the
    device time of the SIMT kernel alone, with its reductions (TN's fold of
    the partials, the GELU backward's column sums), and of
    ``torch.matmul`` on the same f32 operands (a yardstick the port never
    calls) and its bound. Prints the f32 GEMM's device ms per f32
    MAE, JEPA and classifier step (kernel and fold; the column sums are the
    branch's db1)."""
    rows = []
    per_step = dict.fromkeys(F32_GEMM_STEPS, 0.0)
    for geo in F32_GEMM_GEOS:
        L, D, _ = GEOMETRIES[geo]
        for name, (layout, epi, M, N, K, pas) in gemm_products(L, D).items():
            g = torch.Generator(device="cuda").manual_seed(M + N + K)
            rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
            a = rn(*((K, M) if layout == "tn" else (M, K)))
            b = rn(*((N, K) if layout == "nt" else (K, N))) * K**-0.5
            ex = {"bias": 0.1 * rn(N)}
            if epi == "bias_resid":
                ex["resid"] = rn(M, N)
            if epi == "gelu_bwd":
                ex["z"] = rn(M, N)
            got = bf.gemm(a, b, layout, epi, **ex)
            want = bf.gemm_ref(a, b, layout, epi, **ex)
            again = bf.gemm(a, b, layout, epi, **ex)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"gemm f32 {name}@{geo}: a second call differs")
            err, lim = 0.0, 0.0
            for x, y in zip(got, want):
                e = (x - y).abs().max().item()
                bnd = F32_ATOL if layout == "nt" else F32_BWD_REL * y.abs().max().item() + 1e-6
                if not e <= bnd:
                    fail(f"gemm f32 {name}@{geo} ({layout} {epi}): max abs err {e} > {bnd}")
                err, lim = max(err, e), max(lim, bnd)
            del got, want, again
            at, bt = (a.t() if layout == "tn" else a), (b.t() if layout == "nt" else b)
            shares: dict = {}
            device_ms(lambda: (bf.gemm(a, b, layout, epi, **ex), torch.matmul(at, bt)),
                      iters=5, by_kernel=shares)
            k_ms = sum(v for k, v in shares.items() if "gemm_f32_kernel" in k)
            fold_ms = sum(v for k, v in shares.items() if "tn_fold" in k)
            red_ms = fold_ms + sum(v for k, v in shares.items() if "colsum" in k)
            m_ms = sum(shares.values()) - k_ms - red_ms
            if not shares or k_ms <= 0 or m_ms <= 0:
                k_ms, fold_ms, red_ms = cuda_ms(lambda: bf.gemm(a, b, layout, epi, **ex)), 0.0, 0.0
                m_ms = cuda_ms(lambda: torch.matmul(at, bt))
            b_ms, b_by = gemm_f32_bound(layout, epi, M, N, K)
            calls = gemm_calls(name, True)
            rows.append({"geo": geo, "product": name, "pass": pas, "layout": layout, "epi": epi,
                         "M": M, "N": N, "K": K, "calls_per_block": calls, "max_abs_err": err,
                         "kernel_ms": k_ms, "with_reductions_ms": k_ms + red_ms,
                         "matmul_ms": m_ms, "bound_ms": b_ms, "bound_by": b_by})
            print(f"  gemm f32 {geo} {name:5s} {layout} {epi:10s} M={M} N={N} K={K}: kernel "
                  f"{k_ms:.4f} ms (with reductions {k_ms + red_ms:.4f}), matmul {m_ms:.4f}, "
                  f"bound {b_ms:.4f} ({b_by}); kernel/matmul {k_ms / m_ms:.2f}, bound share "
                  f"{b_ms / k_ms:.2f}; max abs err {err:.2e} (bound {lim:.1e})",
                  flush=True)
            for step, blocks in F32_GEMM_STEPS.items():
                n_calls = calls if step != "jepa" or geo != "cls" else gemm_calls(name, False)
                per_step[step] += blocks.get(geo, 0) * n_calls * (k_ms + fold_ms)
            del a, b, ex, at, bt
            torch.cuda.empty_cache()
    print(f"  f32 GEMM device ms per f32 step (table sum, kernel + fold): MAE "
          f"{per_step['mae']:.3f}, JEPA {per_step['jepa']:.3f}, classifier full fine-tune "
          f"{per_step['classifier']:.3f}", flush=True)
    return rows


def check_f32_branches() -> dict:
    """Phase 23 (a): the f32 attention branch (stash forward, backward) and
    the f32 MLP branch's backward against autograd over their plain
    versions at f32, at the model's geometries (B=768, timed per call) and
    F32_ODD_SHAPES: the forward within F32_ATOL, each of the seven backward
    outputs within F32_BWD_REL; one launch of each f32 kernel and no other;
    the no-grad forward equal to the stash forward and a second backward
    equal to the first, bit for bit."""
    per = {k: {} for k in F32_TRAIN_KERNELS}
    errs = dict.fromkeys(F32_TRAIN_KERNELS, 0.0)
    names = ["dx", "d_ln_scale", "d_ln_bias", "d_w_a", "d_b_a", "d_w_b", "d_b_b"]
    cases = [(g, BATCH, *GEOMETRIES[g]) for g in _GRAD_GEOS] + [(None, *s) for s in F32_ODD_SHAPES]
    for geo, B, L, D, H in cases:
        for kind in ("attn", "mlp"):
            x, dy, params = branch_inputs(kind, L, D, seed=B + L + D, batch=B,
                                          dtype=torch.float32)
            extra = (H,) if kind == "attn" else ()
            kern = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
            ref = bf.attn_branch_ref if kind == "attn" else bf.mlp_branch_ref
            leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
            reset_counts()
            out_k = kern(*leaves, *extra)
            grads_k = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
            torch.cuda.synchronize()
            want = {f"{kind}_branch_fwd_f32": 1, f"{kind}_branch_bwd_f32": 1}
            if launch_counts() != expected(want):
                fail(f"f32 {kind}: launched {nonzero(launch_counts())}, expected {want}")
            again = torch.autograd.grad(out_k, leaves, dy, retain_graph=True)
            with torch.no_grad():
                out_ns = kern(x, *params, *extra)
            out_r = ref(*leaves, *extra)
            grads_r = torch.autograd.grad(out_r, leaves, dy, retain_graph=True)
            torch.cuda.synchronize()
            what = f"f32 {kind} B={B} L={L} D={D}"
            if not (torch.equal(out_ns, out_k) and all(map(torch.equal, grads_k, again))):
                fail(f"{what}: the no-grad forward or a second backward differs")
            fwd_err = (out_k - out_r).abs().max().item()
            if not fwd_err <= F32_ATOL:
                fail(f"{what} forward: max abs err {fwd_err} > {F32_ATOL}")
            bwd_err = check_close(what, names, grads_k, grads_r, F32_BWD_REL)
            fwd_key = "attn_branch_fwd_f32" if kind == "attn" else None
            bwd_key = f"{kind}_branch_bwd_f32"
            if fwd_key:
                errs[fwd_key] = max(errs[fwd_key], fwd_err)
            errs[bwd_key] = max(errs[bwd_key], bwd_err)
            line = f"  {what}: fwd max abs err {fwd_err:.3e}, bwd {bwd_err:.3e}"
            if geo is not None:
                (bf_ms, bf_by), (bb_ms, bb_by) = f32_grad_bounds(kind, B, L, D)
                t_bwd = cuda_ms(lambda: torch.autograd.grad(out_k, leaves, dy, retain_graph=True),
                                **F32_TIMING)
                t_pbwd = cuda_ms(lambda: torch.autograd.grad(out_r, leaves, dy,
                                                             retain_graph=True), **F32_TIMING)
                per[bwd_key][geo] = {"ms": t_bwd, "plain_ms": t_pbwd, "bound_ms": bb_ms,
                                     "bound_by": bb_by}
                line += f"; bwd {t_bwd:.3f} ms (plain {t_pbwd:.3f}, bound {bb_ms:.3f} by {bb_by})"
                if fwd_key:
                    t_fwd = cuda_ms(lambda: kern(*leaves, *extra), **F32_TIMING)
                    t_pfwd = cuda_ms(lambda: ref(*leaves, *extra), **F32_TIMING)
                    per[fwd_key][geo] = {"ms": t_fwd, "plain_ms": t_pfwd, "bound_ms": bf_ms,
                                         "bound_by": bf_by}
                    line += (f"; stash fwd {t_fwd:.3f} ms (plain {t_pfwd:.3f}, bound "
                             f"{bf_ms:.3f} by {bf_by})")
            print(line, flush=True)
            del out_k, out_r, out_ns, grads_k, grads_r, again, leaves
            torch.cuda.empty_cache()
    return {k: summarize(per[k], errs[k], STEP_CALLS) for k in F32_TRAIN_KERNELS}


def sdpa_f32_kernels() -> None:
    """Which backend SDPA takes at f32 on this card (the library yardstick of
    the f32 attention entries), as PyTorch's dispatch reports it, and the
    kernels it runs forward and backward at the decoder's shape where the
    profiler records them."""
    from torch.nn.attention import SDPBackend

    L, D, H = GEOMETRIES["dec"]
    leaves, do = attention_inputs("mha_stacked", L, D, H, seed=0, dtype=torch.float32)
    qh, doh = sdpa_inputs("mha_stacked", leaves, do, H)
    choice = torch._fused_sdp_choice(*qh)
    names = {b.value: name for name, b in SDPBackend.__members__.items()}
    print(f"  SDPA at f32 takes the {names.get(choice, choice)} backend "
          "(torch._fused_sdp_choice)", flush=True)
    out = F.scaled_dot_product_attention(*qh)
    for what, fn in (("fwd", lambda: F.scaled_dot_product_attention(*qh)),
                     ("bwd", lambda: torch.autograd.grad(out, qh, doh, retain_graph=True))):
        shares = {}
        ms = device_ms(fn, iters=3, by_kernel=shares)
        print(f"  SDPA at f32, {what}: {ms:.4f} device ms; kernels: "
              f"{kernel_shares(shares) or 'not recorded'}", flush=True)


def attention_bounds_f32(B: int, L: int, D: int):
    """``attention_bounds`` with f32 tensors, at the f32 CUDA-core peak."""
    act, mm = B * L * D * 4, 2 * B * L * L * D
    return bound_f32(4 * act, 2 * mm), bound_f32(7 * act, 5 * mm)


def check_f32_attention() -> dict:
    """Phase 23 (a): the four attention entries at f32 (``csrc/mha_f32.cu``)
    against their plain versions, forward within F32_ATOL and each gradient
    within F32_BWD_REL, one launch each way under the entry's f32 key, at
    their geometries (B=768, timed per call, SDPA at f32 as the library
    call) and F32_ATTN_ODD. A second forward and backward give the same bits
    at every shape (the MAE and JEPA geometries and the fit's edges, (L, d) =
    (256, 32) and (1, 8), among them)."""
    sdpa_f32_kernels()
    mha_occupancy(f32=True)
    res = {}
    for entry, (kern, ref, _, _, where) in ATTENTION.items():
        call = attention_call(entry)
        per = {"fwd": {}, "bwd": {}}
        err = {"fwd": 0.0, "bwd": 0.0}
        cases = [(g, BATCH, *GEOMETRIES[g]) for g in where] + [(None, *s) for s in F32_ATTN_ODD]
        for geo, B, L, D, H in cases:
            leaves, do = attention_inputs(entry, L, D, H, seed=B + L + D, batch=B,
                                          dtype=torch.float32)
            xs = [t.clone().requires_grad_() for t in leaves]
            reset_counts()
            out_k = call(kern, xs, H)
            grads_k = torch.autograd.grad(out_k, xs, do, retain_graph=True)
            torch.cuda.synchronize()
            want = {f"{entry}_fwd_f32": 1, f"{entry}_bwd_f32": 1}
            if launch_counts() != expected(want):
                fail(f"{entry} f32: launched {nonzero(launch_counts())}, expected {want}")
            out_r = call(ref, xs, H)
            grads_r = torch.autograd.grad(out_r, xs, do, retain_graph=True)
            with torch.no_grad():
                out_ng = call(kern, leaves, H)
            torch.cuda.synchronize()
            what = f"{entry} f32 B={B} L={L} D={D} H={H}"
            if not torch.equal(out_ng, out_k):
                fail(f"{what}: the no-grad forward differs from the forward")
            out_2 = call(kern, xs, H)
            grads_2 = torch.autograd.grad(out_2, xs, do)
            if not (torch.equal(out_2, out_k) and all(map(torch.equal, grads_2, grads_k))):
                fail(f"{what}: a second forward and backward differ in their bits")
            del out_2, grads_2
            fwd_err = (out_k - out_r).abs().max().item()
            if not fwd_err <= F32_ATOL:
                fail(f"{what} forward: max abs err {fwd_err} > {F32_ATOL}")
            names = ["dqkv"] if len(xs) == 1 else ["dq", "dk", "dv"]
            bwd_err = check_close(what, names, grads_k, grads_r, F32_BWD_REL)
            err["fwd"], err["bwd"] = max(err["fwd"], fwd_err), max(err["bwd"], bwd_err)
            if geo is not None:
                qh, doh = sdpa_inputs(entry, leaves, do, H)
                out_s = F.scaled_dot_product_attention(*qh)
                with torch.no_grad():
                    t_fwd = {"ms": cuda_ms(lambda: call(kern, leaves, H), **F32_TIMING),
                             "plain_ms": cuda_ms(lambda: call(ref, leaves, H), **F32_TIMING),
                             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*qh),
                                                   **F32_TIMING)}
                t_bwd = {
                    "ms": cuda_ms(lambda: torch.autograd.grad(out_k, xs, do, retain_graph=True),
                                  **F32_TIMING),
                    "plain_ms": cuda_ms(
                        lambda: torch.autograd.grad(out_r, xs, do, retain_graph=True),
                        **F32_TIMING),
                    "library_ms": cuda_ms(
                        lambda: torch.autograd.grad(out_s, qh, doh, retain_graph=True),
                        **F32_TIMING)}
                with torch.no_grad():
                    t_fwd["device_ms"] = device_ms(lambda: call(kern, leaves, H), iters=5)
                    t_fwd["library_device_ms"] = device_ms(
                        lambda: F.scaled_dot_product_attention(*qh), iters=5)
                t_bwd["device_ms"] = device_ms(
                    lambda: torch.autograd.grad(out_k, xs, do, retain_graph=True), iters=5)
                t_bwd["library_device_ms"] = device_ms(
                    lambda: torch.autograd.grad(out_s, qh, doh, retain_graph=True), iters=5)
                (bf_ms, bf_by), (bb_ms, bb_by) = attention_bounds_f32(B, L, D)
                per["fwd"][geo] = {**t_fwd, "bound_ms": bf_ms, "bound_by": bf_by}
                per["bwd"][geo] = {**t_bwd, "bound_ms": bb_ms, "bound_by": bb_by}
                print(f"  {what}: fwd {t_fwd['ms']:.3f} ms (plain {t_fwd['plain_ms']:.3f}, "
                      f"sdpa {t_fwd['library_ms']:.3f}, bound {bf_ms:.3f}), bwd "
                      f"{t_bwd['ms']:.3f} ms (plain {t_bwd['plain_ms']:.3f}, sdpa "
                      f"{t_bwd['library_ms']:.3f}, bound {bb_ms:.3f}); device fwd "
                      f"{t_fwd['device_ms']:.4f} (sdpa {t_fwd['library_device_ms']:.4f}), bwd "
                      f"{t_bwd['device_ms']:.4f} (sdpa {t_bwd['library_device_ms']:.4f}); "
                      f"max abs err fwd {fwd_err:.3e}, bwd {bwd_err:.3e}", flush=True)
                del out_s, qh
            del out_k, out_r, grads_k, grads_r, xs
        print(f"  {entry} f32: {len(cases)} shapes, max abs err fwd {err['fwd']:.3e}, "
              f"bwd {err['bwd']:.3e}", flush=True)
        for pas in ("fwd", "bwd"):
            r = summarize(per[pas], err[pas], {"mae": STEP_CALLS["mae"]})
            res[f"{entry}_{pas}_f32"] = {**r, "step": "mae"}
    return res


def f32_fit(cfg: dict) -> dict:
    """Phase 23 (e): ``Trainer.fit`` of ``MAETask(dtype=torch.float32)`` for
    one epoch on phase 17's synthetic STL-10 at B=F32_FIT_BATCH, no warm-up
    (so that the rate is not ~0 through the epoch), a record per step: every
    step's loss finite, the last three steps' mean below the first three's,
    the val loss finite, and the launches of the epoch exact."""
    import copy
    import tempfile

    c = copy.deepcopy(cfg)
    c["pretrain"].update(batch_size=F32_FIT_BATCH, warmup_epochs=0)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        tmp = pathlib.Path(tmp)
        write_synthetic_stl10(tmp / "data", num_train=1000, num_test=800, num_unlabeled=4000,
                              seed=0, class_signal="texture")
        mtrain, mval = get_pretrain_dataloaders(c, tmp / "data")
        reset_counts()
        trainer = Trainer(MAETask(c["model"], c["pretrain"], dtype=torch.float32, device="cuda"),
                          1, tmp / "mae_f32", hyper_parameters=c, log_every_n_steps=1)
        m = trainer.fit(mtrain, mval)
        got = launch_counts()
        recs = [json.loads(x) for x in (tmp / "mae_f32" / "metrics.jsonl").read_text().splitlines()
                if x]
    losses = [r["train_loss"] for r in recs if "epoch_time_s" not in r]
    print(f"  MAE f32 fit, 1 epoch of {len(mtrain)} steps at B={F32_FIT_BATCH}: step losses "
          f"{[round(v, 5) for v in losses]}; val_loss {m['val_loss']:.5f}", flush=True)
    if (len(losses) != len(mtrain) or not all(map(math.isfinite, losses + [m["val_loss"]]))
            or not np.mean(losses[-3:]) < np.mean(losses[:3])):
        fail(f"f32 fit: step losses {losses}, val_loss {m['val_loss']}")
    steps, evals = len(mtrain), len(mval)
    want = expected(launch_names({
        "attn_branch_fwd": 6 * steps, "attn_branch_bwd": 6 * steps,
        "mlp_branch_fwd": 6 * (steps + evals), "mlp_branch_bwd": 6 * steps,
        "attn_branch_fwd_nograd": 6 * evals}, torch.float32))
    if got != want:
        fail(f"f32 fit launches {nonzero(got)}, expected {nonzero(want)}")
    return got


def f32_fused_equality(model_cfg: dict, impl: str = "auto") -> dict:
    """Phases 23 (f) and 24 (d): ``train_steps_fused`` at f32 on ``impl``
    (under the caller's ``SSRL_FUSED_EMBED``): F32_FUSED_N replayed MAE
    steps (one eager step, the capture, replays) equal as many eager steps
    bit for bit, under deterministic algorithms; returns the host launch
    counts of both runs."""
    runs = []
    embed = ef.use_fused_embed()
    with deterministic(True):
        for fused in (False, True):
            task = MAETask(model_cfg, PRE_CFG, dtype=torch.float32, device="cuda",
                           attn_impl=impl)
            state = task.init_state(0)
            batch, ctx = flagship_images(), task.epoch_context(0)
            torch.cuda.synchronize()
            reset_counts()
            if fused:
                state, sums = task.train_steps_fused(state, batch, 0, ctx, F32_FUSED_N)
            else:
                for _ in range(F32_FUSED_N):
                    state, sums = task.train_step(state, batch, 0, ctx)
            torch.cuda.synchronize()
            runs.append((state, sums, launch_counts()))
            del task
    (se, sums_e, ce), (sg, sums_g, cg) = runs
    a, b = state_tensors(se), state_tensors(sg)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    differ += [k for k in sums_e if k != "lr" and not torch.equal(sums_e[k], sums_g[k])]
    if not torch.equal(se.generator.get_state(), sg.generator.get_state()):
        differ.append("generator")
    print(f"  MAE f32 attn_impl={impl}" + (" SSRL_FUSED_EMBED=1" if embed else "")
          + f": {F32_FUSED_N} replayed vs eager steps, deterministic algorithms: "
          f"{len(differ)} of {len(a) + len(sums_e)} tensors differ", flush=True)
    if differ:
        fail(f"f32 fused: the replayed steps differ from the eager ones in {differ[:8]}")
    # the capture launches one step's kernels, a replay none (host counters)
    per_step = expected(launch_names(mae_launches(impl, embed), torch.float32))
    if ce != {k: v * F32_FUSED_N for k, v in per_step.items()} or cg != {
            k: v * 2 for k, v in per_step.items()}:
        fail(f"f32 fused: eager {nonzero(ce)}, one eager step and the capture {nonzero(cg)}")
    del se, sg
    torch.cuda.empty_cache()
    return {k: ce[k] + cg[k] for k in ce}


def f32_kernel_checks(phase: str) -> dict:
    """Phase 23 (a) or 24 (a), TF32 off: the f32 kernels against their plain
    versions, with their times; the kernel lines' entries."""
    f32 = torch.float32
    with no_tf32():
        if phase == "23":
            t0 = time.perf_counter()
            print(json.dumps({"gemm_f32_table": gemm_f32_table()}), flush=True)
            print(f"  the f32 per-product table: {time.perf_counter() - t0:.1f} s", flush=True)
            res = check_f32_branches()
            res.update(check_f32_attention())
        else:
            res = check_mlp_half(f32)
            res.update(check_stack("block", f32))
            res.update(check_stack("chain", f32))
            res[bf.dtype_key(f32, "chain_bwd")]["mae_step_peak_gib"] = f32_chain_step("mae")[
                "peak_gib"]
            res.update(check_embed(f32))
    return res


def f32_chain_step(task_name: str) -> dict:
    """Phase 24 (a) (and ``tools/torch_f32_stack_ab.py``, on each tree): one
    f32 MAE or JEPA step on the chain with the fused embed at B=768, after
    a warm-up step: its peak device memory (GiB, ``max_memory_allocated``
    over the step) and its device ms (3 steps under the profiler)."""
    cfg = load_config(REPO / "configs" / "mae.yaml")
    with fused_embed(True):
        if task_name == "mae":
            task = MAETask(cfg["model"], PRE_CFG, dtype=torch.float32, device="cuda",
                           attn_impl="chain")
        else:
            task = JEPATask(cfg["model"], {**cfg["jepa"], "batch_size": BATCH},
                            dtype=torch.float32, device="cuda", attn_impl="chain")
        state, batch, ctx = task.init_state(0), flagship_images(), task.epoch_context(0)
        state, _ = task.train_step(state, batch, 0, ctx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = task.train_step(state, batch, 0, ctx)
        torch.cuda.synchronize()
        res = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "device_ms": device_ms(lambda: task.train_step(state, batch, 0, ctx), iters=3)}
    print(f"  f32 {task_name.upper()} step on chain, SSRL_FUSED_EMBED=1, B={BATCH}: peak "
          f"memory {res['peak_gib']:.3f} GiB, {res['device_ms']:.3f} device ms", flush=True)
    del task, state, batch
    torch.cuda.empty_cache()
    return res


def kernels_process(phase: str, *args: str) -> dict:
    """``chip_smoke.py *args OUT`` in a process of its own, as phase 21
    runs: after the earlier phases' many profiler sessions (and CUDA-graph
    captures) this process's profiler loses some calls' largest kernels
    (SDPA's f32 backward read 0.58 of its 2.98 ms, the embed's f32 backward
    0.01 of its 0.10) or, by phase 25, records no device time at all (on an
    H100), so the device times come from a fresh one. Its output goes to
    ours; returns its kernel lines' entries."""
    out = REPO / "build" / f"tmp_kernels_{phase.replace(' ', '_')}_{os.getpid()}.json"
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args, str(out)],
                              cwd=REPO, timeout=600)
        print(f"  phase {phase}'s process: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode != 0:
            fail(f"phase {phase}'s process exited {proc.returncode}")
        return json.loads(out.read_text())
    finally:
        out.unlink(missing_ok=True)


def f32_kernels_process(phase: str) -> dict:
    """Phase 23 (a) or 24 (a) in a process of its own (``--f32-kernels``)."""
    return kernels_process(f"{phase} (a)", "--f32-kernels", phase)


def f32_kernels_main(phase: str, out: pathlib.Path) -> None:
    """``--f32-kernels PHASE OUT``: phase 23 (a) or 24 (a) on the kernels
    the parent built; the kernel lines' entries as JSON in OUT."""
    _build.load()
    out.write_text(json.dumps(f32_kernel_checks(phase)))


def f32_training(cfg: dict, name: str):
    """Phase 23: f32 training on the card, TF32 off. Returns (the kernel
    lines' entries, the host launch counts of the main-path runs)."""
    model_cfg = cfg["model"]
    jepa_cfg = {**cfg["jepa"], "batch_size": BATCH}
    train_cfg = {**cfg["train"], "batch_size": BATCH}
    f32 = torch.float32
    counts = dict.fromkeys(launch_counts(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    print("phase 23 (a): the f32 kernels vs their plain versions", flush=True)
    res = f32_kernels_process("23")
    with no_tf32():
        print("phase 23 (b): the MAE, JEPA and classifier steps at f32, B=768, auto", flush=True)
        add(mae_step(model_cfg, name, "auto", dtype=f32)[0])
        add(jepa_step(model_cfg, jepa_cfg, name, fused=False, dtype=f32)[0])
        add(classifier_steps(model_cfg, train_cfg, name, dtype=f32)[0])
        print("phase 23 (c): the MAE step at f32 on packed and pallas", flush=True)
        for impl in ("packed", "pallas"):
            add(mae_step(model_cfg, name, impl, dtype=f32)[0])
        print("phase 23 (d): B=16 f32 steps, kernels vs plain CPU path", flush=True)
        for impl in ("auto", "packed", "pallas"):
            cpu_agreement(model_cfg, impl, dtype=f32)
        jepa_cpu_agreement(model_cfg, jepa_cfg, dtype=f32)
        classifier_cpu_agreement(model_cfg, train_cfg, dtype=f32)
        print("phase 23 (e): Trainer.fit of the f32 MAE task, one epoch", flush=True)
        add(f32_fit(cfg))
        print("phase 23 (f): train_steps_fused at f32 vs eager steps", flush=True)
        add(f32_fused_equality(model_cfg))
    return res, counts


def f32_stack_routes(cfg: dict, name: str):
    """Phase 24: f32 on attn_impl block and chain with the fused embed, TF32
    off. Returns (the kernel lines' entries, the host launch counts of the
    main-path runs)."""
    model_cfg = cfg["model"]
    jepa_cfg = {**cfg["jepa"], "batch_size": BATCH}
    train_cfg = {**cfg["train"], "batch_size": BATCH}
    f32 = torch.float32
    counts = dict.fromkeys(launch_counts(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    print("phase 24 (a): the f32 MLP half, whole block, chain and patch embed vs their "
          "plain versions", flush=True)
    res = f32_kernels_process("24")
    with no_tf32():
        print("phase 24 (b): MAE and JEPA on block and chain, the classifier's full "
              "fine-tune on block, f32, B=768, SSRL_FUSED_EMBED=1", flush=True)
        step_ms = {}
        for impl in ("block", "chain"):
            c, step_ms[f"mae_{impl}"] = mae_step(model_cfg, name, impl, fused=True, dtype=f32)
            add(c)
            c, step_ms[f"jepa_{impl}"] = jepa_step(model_cfg, jepa_cfg, name, fused=True,
                                                   impl=impl, dtype=f32)
            add(c)
        with fused_embed(True):
            c, cls_ms = classifier_steps(model_cfg, train_cfg, name, policies=("full",),
                                         dtype=f32, impl="block")
            add(c)
            step_ms["classifier_full_block"] = cls_ms["full"]
            print(json.dumps({"f32_step_ms": step_ms}), flush=True)
            print("phase 24 (c): B=16 f32 steps on the same routes, kernels vs plain CPU path",
                  flush=True)
            for impl in ("block", "chain"):
                cpu_agreement(model_cfg, impl, dtype=f32)
                jepa_cpu_agreement(model_cfg, jepa_cfg, impl, dtype=f32)
            classifier_cpu_agreement(model_cfg, train_cfg, policies=("full",), dtype=f32,
                                     impl="block")
            print("phase 24 (d): train_steps_fused at f32 on block with the fused embed vs "
                  "eager steps", flush=True)
            add(f32_fused_equality(model_cfg, "block"))
    idle = [k for k in (bf.dtype_key(f32, k) for k in F32_STACK_SOURCES) if not counts[k]]
    if idle:
        fail(f"phase 24: the main-path runs never launched {idle}")
    return res, counts


# ---------------------------------------------------------------------------
# Phase 25: the tensor-parallel model axis (Megatron-sharded blocks on the
# branch kernels over a (data, model) grid), and --tp-cards
# ---------------------------------------------------------------------------

TP = 2  # the model axis of phase 25 and of --tp-cards
# (a): each TP entry at the shard widths of model_parallel=2 (Da = 3 heads,
# F/2), per call at these geometries; per rank and MAE step at the encoder
# and decoder ("<geo>_mlp": the MLP branch's finish and LN backward), the
# no-grad attention forward per JEPA step at the target encoder's
TP_GEOS = ("enc", "dec", "pred", "tgt")
TP_STEP_CALLS = {"mae": {"enc": 4, "dec": 2, "enc_mlp": 4, "dec_mlp": 2}}
TP_NOGRAD_CALLS = {"jepa": {"tgt": 4}}
# TP entry -> (bf16 source, the TPU kernel whose function it splits): the
# finish is the bias-residual epilogue of _ab_fwd / _mb_fwd, the LN backward
# the last stage of _ab_bwd / _mb_bwd
TP_KERNELS = {
    "attn_branch_part_fwd": ("attn_branch.cu", _TPU + "block_pallas.py:722"),
    "attn_branch_part_fwd_nograd": ("attn_branch.cu", _TPU + "block_pallas.py:692"),
    "attn_branch_part_bwd": ("attn_branch.cu", _TPU + "block_pallas.py:752"),
    "mlp_branch_part_fwd": ("mlp_branch.cu", _TPU + "block_pallas.py:807"),
    "mlp_branch_part_bwd": ("mlp_branch.cu", _TPU + "block_pallas.py:831"),
    "branch_finish": ("attn_branch.cu", _TPU + "block_pallas.py:722"),
    "branch_ln_bwd": ("attn_branch.cu", _TPU + "block_pallas.py:752"),
}
TP_TASKS = ("mae", "jepa", "cls_full", "cls_probe")
TP_B = 16  # (b): the steps against the single process
TP_TIMING = {"iters": 10, "warmup": 2}
# (c): the fit's synthetic STL-10 (train, test, unlabeled) and its schedule:
# two epochs over a mask ramp, 32 train and 8 val images at B=16
TP_FIT_DATA = (10, 10, 40)
TP_FIT_CFG = {**PRE_CFG, "batch_size": TP_B, "mask_ratio_start": 0.5, "mask_ratio_end": 0.75,
              "mask_ramp_epochs": 2, "total_epochs": 2, "warmup_epochs": 1, "val_split": 0.2,
              "num_workers": 0}


def tp_launches(kind: str) -> dict:
    """One rank's TP launches per step of ``kind``: per block with a
    gradient the two partial forwards and backwards, two finishes and two
    LN backwards; per no-grad block (the JEPA target, the frozen encoder)
    the no-stash attention forward, the MLP forward and two finishes."""
    grad, nograd = {"mae": (6, 0), "jepa": (6, 4), "cls_full": (4, 0),
                    "cls_probe": (0, 4)}[kind]
    out = {"attn_branch_part_fwd": grad, "attn_branch_part_fwd_nograd": nograd,
           "attn_branch_part_bwd": grad, "mlp_branch_part_fwd": grad + nograd,
           "mlp_branch_part_bwd": grad, "branch_finish": 2 * (grad + nograd),
           "branch_ln_bwd": 2 * grad}
    return {k: v for k, v in out.items() if v}


def tp_operands(kind: str, params, m: int, mp: int = TP):
    """Model rank m's five partial-kernel operands of a branch's full
    params (ln_s, ln_b, wa, ba, wb, bb): parallel/mesh.py's layout."""
    D = params[0].shape[0]
    dev = params[0].device
    if kind == "attn":
        rows = shard_index(ShardSpec(0, 3), 3 * D, mp, m).to(dev)
        cols = shard_index(ShardSpec(1), D, mp, m).to(dev)
        return (params[0], params[1], params[2][rows], params[3][rows], params[4][:, cols])
    fs = shard_index(ShardSpec(0), params[2].shape[0], mp, m).to(dev)
    return (params[0], params[1], params[2][fs], params[3][fs], params[4][:, fs])


def tp_bounds(kind: str, L: int, D: int, w: int, dtype, stash: bool = True) -> dict:
    """Per-call bounds of one shard's TP entries at (BATCH, L, D), ``w`` the
    shard's attention width Da or hidden slice F/mp: inputs read once,
    outputs written once (the partial sums and dy in f32), weights once
    (their f32 gradients written once), and the products the function
    needs (the backward recomputes the first product from x); at f32 the
    operations at the f32 CUDA-core rate."""
    M, e = BATCH * L, (4 if dtype == torch.float32 else 2)
    bnd = bound_f32 if dtype == torch.float32 else bound
    act, f32 = M * D * e, M * D * 4
    if kind == "attn":
        wts, att = 4 * w * D, BATCH * L * L * w
        fwd = bnd(act + f32 + (M * w * e if stash else 0) + wts * e, 8 * M * D * w + 4 * att)
        bwd = bnd(2 * act + M * w * e + f32 + wts * (e + 4), 22 * M * D * w + 10 * att)
    else:
        wts = 2 * w * D
        fwd = bnd(act + f32 + wts * e, 4 * M * D * w)
        bwd = bnd(2 * act + f32 + wts * (e + 4), 10 * M * D * w)
    return {"fwd": fwd, "bwd": bwd, "finish": bnd(2 * act + f32, 2 * M * D),
            "ln_bwd": bnd(3 * act + f32, 12 * M * D)}


def tp_entry(per: dict, errs: dict, key: str, geo: str, fns: tuple, bnd: tuple,
             err: float) -> None:
    """A TP entry's times at ``geo``: ``fns`` = (the kernel's call, the plain
    version's), CUDA-event means of each and the kernel's device time."""
    t = TP_TIMING
    per.setdefault(key, {})[geo] = {"ms": cuda_ms(fns[0], **t), "plain_ms": cuda_ms(fns[1], **t),
                                    "device_ms": device_ms(fns[0], iters=5),
                                    "bound_ms": bnd[0], "bound_by": bnd[1]}
    errs[key] = max(errs.get(key, 0.0), err)


def tp_close(what: str, got, want, rel: float) -> float:
    """max |got - want| within ``rel`` of want's largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    lim = rel * want.float().abs().max().item() + 1e-6
    if not err <= lim:
        fail(f"{what}: max abs err {err:.3e} > {lim:.3e}")
    return err


def check_tp_kernels(dtype) -> dict:
    """Phase 25 (a) at ``dtype``: at each geometry of TP_GEOS both shards of
    each branch through the partial kernels against their plain versions
    (forward within FWD_ATOL / F32_ATOL, the no-stash forward the same
    bits; each backward output within BWD_REL / F32_BWD_REL of its largest
    magnitude, fed the kernel's own stash), the finish and the LN backward
    on the shards' sums against theirs, and the whole: the finished sum
    against the unsplit branch kernel's forward, the LN backward's dx
    against its backward. Times per call of rank 0's shard, CUDA-event
    means and device time."""
    f32 = dtype == torch.float32
    fwd_tol, bwd_rel = (F32_ATOL, F32_BWD_REL) if f32 else (FWD_ATOL, BWD_REL)
    per, errs = {}, {}
    for geo in TP_GEOS:
        L, D, H = GEOMETRIES[geo]
        grad = geo != "tgt"
        for kind in ("attn", "mlp"):
            x, dy, params = branch_inputs(kind, L, D, seed=L + D + 1, dtype=dtype)
            hl = H // TP
            w = (D if kind == "attn" else 4 * D) // TP
            key = f"{geo}" if kind == "attn" else f"{geo}_mlp"
            what = f"{kind}@{geo} {DT_NAME[dtype]} shard"
            bnds = tp_bounds(kind, L, D, w, dtype, stash=grad)
            s = dys = 0
            for m in range(TP):
                p = tp_operands(kind, params, m)
                if kind == "attn":
                    part, a = bf.attn_branch_partial(x, p, hl, stash=True)
                    part_ns, _ = bf.attn_branch_partial(x, p, hl, stash=False)
                    ref, _ = bf.attn_part_plain(x, p, hl)
                    if not torch.equal(part_ns, part):
                        fail(f"{what} {m}: the no-stash forward differs from the stash one")
                else:
                    part = bf.mlp_branch_partial(x, p)
                    ref = bf.mlp_part_plain(x, p)
                ferr = (part - ref).abs().max().item()
                if not ferr <= fwd_tol:
                    fail(f"{what} {m} partial forward: max abs err {ferr} > {fwd_tol}")
                s = s + part
                if grad:
                    if kind == "attn":
                        dy1, gk = bf.attn_branch_partial_bwd(x, p, a, dy, hl)
                        dy1_r, gr = bf.attn_part_bwd_plain(x, p, a, dy, hl)
                    else:
                        dy1, gk = bf.mlp_branch_partial_bwd(x, p, dy)
                        dy1_r, gr = bf.mlp_part_bwd_plain(x, p, dy)
                    berr = max(tp_close(f"{what} {m} backward {n}", k, r, bwd_rel)
                               for n, k, r in zip(("dy", "dw_a", "db_a", "dw_b"),
                                                  (dy1, *gk), (dy1_r, *gr)))
                    dys = dys + dy1
                if m:
                    continue
                if kind == "attn":  # rank 0's shard: times per call
                    with torch.no_grad():
                        tp_entry(per, errs, f"attn_branch_part_fwd{'' if grad else '_nograd'}",
                                 geo, (lambda: bf.attn_branch_partial(x, p, hl, grad),
                                       lambda: bf.attn_part_plain(x, p, hl)), bnds["fwd"], ferr)
                    if grad:
                        tp_entry(per, errs, "attn_branch_part_bwd", geo, (
                            lambda: bf.attn_branch_partial_bwd(x, p, a, dy, hl),
                            lambda: bf.attn_part_bwd_plain(x, p, a, dy, hl)), bnds["bwd"], berr)
                else:
                    tp_entry(per, errs, "mlp_branch_part_fwd", key, (
                        lambda: bf.mlp_branch_partial(x, p), lambda: bf.mlp_part_plain(x, p)),
                        bnds["fwd"], ferr)
                    if grad:
                        tp_entry(per, errs, "mlp_branch_part_bwd", key, (
                            lambda: bf.mlp_branch_partial_bwd(x, p, dy),
                            lambda: bf.mlp_part_bwd_plain(x, p, dy)), bnds["bwd"], berr)
            bias = params[5]
            out = bf.branch_finish(x, s, bias)
            out_r = bf.branch_finish_plain(x, s, bias)
            err = (out.float() - out_r.float()).abs().max().item()
            if not err <= fwd_tol:
                fail(f"{what}: finish max abs err {err} > {fwd_tol}")
            tp_entry(per, errs, "branch_finish", key, (
                lambda: bf.branch_finish(x, s, bias), lambda: bf.branch_finish_plain(x, s, bias)),
                bnds["finish"], err)
            full_fn = bf.fused_attn_branch if kind == "attn" else bf.fused_mlp_branch
            extra = (H,) if kind == "attn" else ()
            leaves = [x.clone().requires_grad_(grad)] + [q.clone().requires_grad_(grad)
                                                       for q in params]
            whole = full_fn(*leaves, *extra)
            werr = (whole.float() - out.float()).abs().max().item()
            if not werr <= fwd_tol:
                fail(f"{what}: the finished shards vs the whole branch: {werr} > {fwd_tol}")
            line = (f"  {kind}@{geo} {DT_NAME[dtype]} L={L} D={D} shard width {w}: partial "
                    f"forward err {ferr:.3e}, finish err {err:.3e}, the whole branch within "
                    f"{werr:.3e}")
            if grad:
                dx, dln = bf.branch_ln_bwd(x, params[0], dys, dy)
                dx_r, dln_r = bf.ln_bwd_plain(x, params[0], dys, dy)
                lerr = max(tp_close(f"{what} LN backward {n}", k, r, bwd_rel)
                           for n, k, r in zip(("dx", "d_ln_s", "d_ln_b", "d_bias"),
                                              (dx, *dln), (dx_r, *dln_r)))
                tp_entry(per, errs, "branch_ln_bwd", key, (
                    lambda: bf.branch_ln_bwd(x, params[0], dys, dy),
                    lambda: bf.ln_bwd_plain(x, params[0], dys, dy)), bnds["ln_bwd"], lerr)
                gw = torch.autograd.grad(whole, leaves, dy)
                wbe = tp_close(f"{what}: dx of the shards vs the whole branch", dx, gw[0],
                               bwd_rel)
                for n, k, r in (("d_ln_s", dln[0], gw[1]), ("d_ln_b", dln[1], gw[2]),
                                ("d_bias", dln[2], gw[6])):
                    wbe = max(wbe, tp_close(f"{what}: {n} of the shards vs the whole branch",
                                            k, r, bwd_rel))
                line += f"; backward err {berr:.3e}, LN backward {lerr:.3e}, whole {wbe:.3e}"
            print(line, flush=True)
            del x, dy, params, leaves, whole
    out = {}
    for k, v in per.items():
        calls = TP_NOGRAD_CALLS if k == "attn_branch_part_fwd_nograd" else TP_STEP_CALLS
        out[bf.dtype_key(dtype, k)] = summarize(v, errs[k], calls)
        line = ", ".join(f"{g} {d['ms']:.3f} ms (device {d['device_ms']:.4f}, plain "
                         f"{d['plain_ms']:.3f}, bound {d['bound_ms']:.4f})" for g, d in v.items())
        print(f"  {bf.dtype_key(dtype, k)} per call: {line}", flush=True)
    return out


def tp_task(kind: str, cfg: dict, dtype, batch: int):
    """The flagship MAE, JEPA or classifier task (auto) at ``batch`` rows."""
    model = cfg["model"]
    if kind == "mae":
        return MAETask(model, {**PRE_CFG, "batch_size": batch}, dtype=dtype, device="cuda")
    if kind == "jepa":
        return JEPATask(model, {**cfg["jepa"], "batch_size": batch}, dtype=dtype,
                        device="cuda")
    policy = "full" if kind == "cls_full" else "probe"
    return classifier_task(model, {**cfg["train"], "batch_size": batch}, policy, "cuda",
                           dtype=dtype)


def tp_check_worker(grid, out_dir: pathlib.Path, cfg: dict) -> dict:
    """Phase 25 (b) on this rank: its data rank's rows of a B=TP_B step of
    each task at bf16 and f32 on its shards; the gradients gathered, the
    launches of the gradients and of a whole train step, and its copies of
    the replicated params after it; then (c) the fit."""
    out = {}
    b = TP_B // grid.data.size
    full = flagship_images(n=TP_B)
    rows = slice(grid.data.rank * b, (grid.data.rank + 1) * b)
    batch = {k: v[rows] for k, v in full.items()}
    for dtype in (torch.bfloat16, torch.float32):
        for kind in TP_TASKS:
            task = tp_task(kind, cfg, dtype, TP_B)
            task.configure_sharding(grid)
            state = task.init_state(0)
            ctx = task.epoch_context(0)
            reset_counts()
            names, grads, sums = task.gradients(state, batch, ctx)
            torch.cuda.synchronize()
            launches = launch_counts()
            state, _ = task.train_step(state, batch, 0, ctx)
            torch.cuda.synchronize()
            full_grads = gather_params(dict(zip(names, grads)), grid.model)
            out[(kind, DT_NAME[dtype])] = {
                "names": names, "grads": {k: v.float().cpu() for k, v in full_grads.items()},
                "sums": {k: float(v) for k, v in sums.items()}, "launches": launches,
                "launches_with_step": launch_counts(),
                "replicated": {k: v.detach().cpu() for k, v in state.params.items()
                               if shard_spec(k) is None}}
            del task, state
    out["fit"] = tp_fit(grid, out_dir)
    return out


def tp_fit(grid, out_dir: pathlib.Path) -> dict:
    """Phase 25 (c) on this rank: the flagship MAE over the grid, one epoch
    then a resume to the second, beside two epochs straight, over an active
    mask ramp on a synthetic STL-10; the gathered state at the checkpoint
    the resume starts from, and at the end of both runs."""
    cfg = {"seed": 73, "pretrain": TP_FIT_CFG}
    model = load_config(REPO / "configs" / "mae.yaml")["model"]
    train, val = get_pretrain_dataloaders(cfg, out_dir / "data")
    reset_counts()

    def run(epochs, name, **kw):
        task = MAETask(model, TP_FIT_CFG, dtype=torch.bfloat16, device="cuda")
        tr = Trainer(task, epochs, out_dir / name, mesh=grid)
        metrics = tr.fit(train, val, **kw)
        return tr, metrics

    a, _ = run(1, "run_a")
    names = a.task.tx.trainable(a.state.params)
    opt = a.state.opt_state
    first = {k: {n: v.detach().cpu() for n, v in gather_params(d, grid.model).items()}
             for k, d in (("params", a.state.params), ("mu", dict(zip(names, opt.mu))),
                          ("nu", dict(zip(names, opt.nu))))}
    b, _ = run(2, "run_b", resume_from=out_dir / "run_a" / "checkpoints" / "last.ckpt")
    c, metrics = run(2, "run_c")
    torch.cuda.synchronize()
    return {"first": first, "launches": launch_counts(), "steps": len(train),
            "resumed": {k: v.detach().cpu() for k, v in
                        gather_params(b.state.params, grid.model).items()},
            "straight": {k: v.detach().cpu() for k, v in
                         gather_params(c.state.params, grid.model).items()},
            "metrics": metrics, "mask_ratios": [a.task.host_epoch_metrics(e)["mask_ratio"]
                                                for e in range(2)]}


def tp_timed_worker(grid, cfg: dict) -> dict:
    """One rank of ``--tp-cards``: the flagship MAE, JEPA and full classifier
    steps at BATCH rows a data rank (bf16, auto) on this rank's card:
    CUDA-event ms/step over STEPS steps after WARMUP, the launches of those
    steps, and the device ms/step of 3 more under torch.profiler (one
    session on every rank, so the ranks stay in step; None where it
    recorded no device time)."""
    out = {}
    batch = flagship_images()
    for kind in ("mae", "jepa", "cls_full"):
        task = tp_task(kind, cfg, torch.bfloat16, BATCH * grid.shape["data"])
        task.configure_sharding(grid)
        state = task.init_state(0)
        ctx = task.epoch_context(0)
        for _ in range(WARMUP):
            state, sums = task.train_step(state, batch, 0, ctx)
        torch.distributed.barrier()
        torch.cuda.synchronize()
        reset_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(STEPS):
            state, sums = task.train_step(state, batch, 0, ctx)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / STEPS
        launches = launch_counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                state, sums = task.train_step(state, batch, 0, ctx)
            torch.cuda.synchronize()
        dev = sum(device_us(e) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 3e3
        out[kind] = {"ms": ms, "device_ms": dev or None, "launches": launches,
                     "loss": float(sums["loss_sum"]) / float(sums["weight_sum"])}
        del task, state
        torch.cuda.empty_cache()
    return out


def tp_worker(out_dir: pathlib.Path, backend: str, mp: int, mode: str) -> None:
    """One rank of phase 25 (b, c) (``mode`` "check", two ranks sharing the
    card over ``gloo``) or of ``--tp-cards`` ("timed", one rank a card over
    ``nccl``; ``mp`` 1 is the data-parallel comparison), a process of its
    own in the (world / mp, mp) grid of ``parallel/mesh.py::get_mesh``."""
    if not maybe_initialize_distributed("cuda", backend=backend):
        fail("tp worker: no process group in the environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    grid = get_mesh(model_parallel=mp)
    cfg = load_config(REPO / "configs" / "mae.yaml")
    if mode == "check":
        old = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        out = tp_check_worker(grid, out_dir, cfg)
        torch.use_deterministic_algorithms(old)
    else:
        out = tp_timed_worker(grid, cfg)
    out["grid"] = (grid.shape["data"], grid.shape["model"])
    torch.save(out, out_dir / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.destroy_process_group()


def tp_spawn(tmp: pathlib.Path, ranks: int, backend: str, mp: int, mode: str,
             shared_card: bool) -> list:
    """The ranks of ``tp_worker``, run to their end; their results."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--tp-worker", str(tmp), backend,
         str(mp), mode], cwd=REPO,
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
            fail(f"tp rank {r} exited {p.returncode}\n{out[-3000:]}\n{err[-3000:]}")
    print(f"  {ranks} {backend} ranks in a ({ranks // mp}, {mp}) grid: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(ranks)]


def tp_steps(cfg: dict) -> dict:
    """Phase 25 (b) and (c): two ranks sharing the card over ``gloo`` in a
    (1, 2) grid (``--tp-worker``). (b) each task's B=TP_B step at bf16 and
    f32 against this process's single step from the same seed: the loss
    within the phase-20 bounds (LOSS_RTOL, F32_LOSS_RTOL), every gathered
    gradient within STEP_GRAD_REL / F32_BWD_REL of the single one's largest
    magnitude, exact TP launches per step on each rank, and the replicated
    params the same bits on both ranks after the step; (c) the fit's
    checkpoint holds the gathered params and Adam moments, loads in this
    process and takes a step there, and the resume equals two epochs
    straight bit for bit. Returns the ranks' launches."""
    import tempfile

    launches = dict.fromkeys(launch_counts(), 0)
    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = pathlib.Path(tmp)
        write_synthetic_stl10(tmp / "data", *TP_FIT_DATA, seed=0)
        ranks = tp_spawn(tmp, TP, "gloo", TP, "check", shared_card=True)
        for (kind, dt), _ in [kv for kv in ranks[0].items() if isinstance(kv[0], tuple)]:
            dtype = torch.float32 if dt == "f32" else torch.bfloat16
            loss_rtol, grad_rel = step_tolerances(dtype)
            task = tp_task(kind, cfg, dtype, TP_B)
            state = task.init_state(0)
            names, grads, sums = task.gradients(state, flagship_images(n=TP_B),
                                                task.epoch_context(0))
            want = launch_names(tp_launches(kind), dtype)
            for r, rk in enumerate(x[(kind, dt)] for x in ranks):
                what = f"{kind} {dt} model rank {r} of {TP}"
                if (rk["launches"] != expected(want)
                        or rk["launches_with_step"] != expected(want, 2)):
                    fail(f"{what}: launches {nonzero(rk['launches'])} (then "
                         f"{nonzero(rk['launches_with_step'])}), expected {want} per step")
                for k, v in rk["launches_with_step"].items():
                    launches[k] += v
                if rk["names"] != names:
                    fail(f"{what}: trains {rk['names'][:4]}..., the single step {names[:4]}...")
                loss, want_loss = rk["sums"]["loss_sum"], float(sums["loss_sum"])
                if not abs(loss - want_loss) <= loss_rtol * abs(want_loss):
                    fail(f"{what}: loss sum {loss} vs {want_loss} (rtol {loss_rtol})")
                worst = max(tp_close(f"{what} gradient {k}", rk["grads"][k], g.float().cpu(),
                                     grad_rel) / (grad_rel * g.float().abs().max().item() + 1e-6)
                            for k, g in zip(names, grads))
                print(f"  {what}: loss sum {loss:.6f} (single {want_loss:.6f}); {len(names)} "
                      f"gradients, the worst at {worst:.3f} of its bound", flush=True)
            rep = [k for k, v in ranks[0][(kind, dt)]["replicated"].items()
                   if not torch.equal(v, ranks[1][(kind, dt)]["replicated"][k])]
            if rep:
                fail(f"{kind} {dt}: replicated params differ between the model ranks: {rep[:4]}")
            del task, state
        fits = [x["fit"] for x in ranks]
        for r, f in enumerate(fits):
            diff = [k for k, v in f["straight"].items() if not torch.equal(f["resumed"][k], v)]
            if diff:
                fail(f"fit model rank {r}: the resume differs from two epochs straight in "
                     f"{diff[:4]}")
            for k, v in f["launches"].items():
                launches[k] += v
        first = fits[0]["first"]
        ckpt = load_checkpoint(tmp / "run_a" / "checkpoints" / "last.ckpt")
        st = model_state(ckpt)
        diff = [k for k, v in first["params"].items() if not torch.equal(st[k], v)]
        diff += [f"{m}:{k}" for m in ("mu", "nu") for k, v in first[m].items()
                 if not torch.equal(ckpt["optimizer"][m][k], v)]
        if diff:
            fail(f"the (1, {TP}) checkpoint differs from the gathered state in {diff[:4]}")
        task = MAETask(cfg["model"], TP_FIT_CFG, dtype=torch.bfloat16, device="cuda")
        state = restore_state(ckpt, task.init_state(0), task.model, task.tx)
        diff = [k for k, v in first["params"].items()
                if not torch.equal(state.params[k].detach().cpu(), v)]
        if diff:
            fail(f"the (1, {TP}) checkpoint loaded in one process differs in {diff[:4]}")
        batch = flagship_images(n=TP_B)
        state, sums = task.train_step(state, batch, 1, task.epoch_context(1))
        loss = float(sums["loss_sum"]) / TP_B
        print(f"  fit: {fits[0]['steps']} steps an epoch, mask ratio "
              f"{fits[0]['mask_ratios']}, val loss {fits[0]['metrics']['val_loss']:.5f}; the "
              f"resume equals two epochs straight on both ranks; the checkpoint holds "
              f"{len(first['params'])} full params and {len(first['mu'])} + {len(first['nu'])} "
              f"moments, the gathered ones, and loads in one process (a step there: loss "
              f"{loss:.5f})", flush=True)
        if not math.isfinite(loss):
            fail(f"a step from the (1, {TP}) checkpoint in one process: loss {loss}")
    return launches


def tp_kernels_main(out: pathlib.Path) -> None:
    """``--tp-kernels OUT``: phase 25 (a) at bf16 and f32 on the kernels the
    parent built, TF32 off; the kernel lines' entries as JSON in OUT."""
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = check_tp_kernels(torch.bfloat16)
    res.update(check_tp_kernels(torch.float32))
    out.write_text(json.dumps(res))


def tensor_parallel(cfg: dict):
    """Phase 25: (a) at bf16 and f32 in a process of its own
    (``--tp-kernels``), then (b) and (c); returns the kernel results and the
    launches."""
    res = kernels_process("25 (a)", "--tp-kernels")
    return res, tp_steps(cfg)


# phase 26: the rank study at a small scale (tools/torch_rank_study.sh with
# 6,000 unlabeled images and one epoch: a few steps at B=2000 a pretraining)
RANK_SMALL = {"SSRL_RANK_EPOCHS": "1", "SSRL_RANK_UNLABELED": "6000"}
RANK_ROWS = {"knn": 4, "ridge": 4, "knn_mean": 3, "probes": 3}
# the kernels the study's CLIs launch: rows 1, 2, 4, 5 in both pretrainings,
# row 3 in the JEPA target encoder and the frozen probes, rows 3-4 at f32 in
# every knn_eval feature pass
RANK_KERNELS = ("attn_branch_fwd", "attn_branch_bwd", "mlp_branch_fwd", "mlp_branch_bwd",
                "attn_branch_fwd_nograd", "attn_branch_fwd_nograd_f32", "mlp_branch_fwd_f32")


# phase 26 (b): one pretraining step of each kind at the study's batch
# (B=2000: 74,000 encoder and 290,000 decoder rows in MAE) and at its partial
# last batch (STUDY_PARTIAL real rows, the rest wrap-around padding at weight
# 0), the kernels (bf16, auto) against the plain route (bf16, xla: no kernel
# of csrc/) on the card from the same weights, EMA target and draws, at
# phase 4's tolerances; beside them each route's relative L2 distance from
# the plain route at f32, over all trainable gradients
STUDY_PARTIAL = 200
STUDY_ROUTES = {"plain": ("xla", torch.bfloat16), "plain_f32": ("xla", torch.float32)}


def study_task(kind: str, cfg: dict, impl: str, dtype):
    """The study's MAE or JEPA task on the card, as its CLI builds it."""
    if kind == "mae":
        return MAETask(cfg["model"], cfg["pretrain"], dtype=dtype, device="cuda",
                       attn_impl=impl)
    return JEPATask(cfg["model"], cfg["jepa"], dtype=dtype, device="cuda", attn_impl=impl)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors, in f32."""
    num = sum(float((x.float() - y.float()).square().sum()) for x, y in zip(a, b))
    return math.sqrt(num / sum(float(y.float().square().sum()) for y in b))


def study_steps(cfg: dict) -> dict:
    """Phase 26 (b): the step agreement above, for MAE and JEPA, at the
    full and the partial batch of ``cfg``'s pretraining; fails on a loss or
    gradient out of bound, or when the kernel route launched no kernel or
    the plain routes one; returns the losses and distances."""
    batch = cfg["pretrain"]["batch_size"]
    images = flagship_images(seed=26, n=batch)["image"]
    res = {}
    for kind in ("mae", "jepa"):
        kern = study_task(kind, cfg, "auto", torch.bfloat16)
        state = kern.init_state(0)
        plain, states = {}, {}
        for route, (impl, dtype) in STUDY_ROUTES.items():
            plain[route] = study_task(kind, cfg, impl, dtype)
            states[route] = plain[route].init_state(0)
            plain[route].model.load_state_dict(kern.model.state_dict())
            if state.extra is not None:  # JEPA's EMA target
                states[route].extra = {k: v.clone() for k, v in state.extra.items()}
        ctx = kern.epoch_context(0)
        draws = kern.draw(state.generator, batch, ctx)
        res[kind] = {}
        for part, real in (("full", batch), ("partial", STUDY_PARTIAL)):
            what = f"{kind} step B={batch} with {real} real rows"
            data = {"image": images,
                    "weight": (torch.arange(batch, device="cuda") < real).float()}
            reset_counts()
            names, g_k, s_k = kern.gradients(state, data, ctx, draws)
            launched = launch_counts()
            if not any(launched.values()):
                fail(f"{what}: the kernel route launched no kernel")
            got = {"kernels": (g_k, s_k)}
            for route, task in plain.items():
                names_p, g, s = task.gradients(states[route], data, ctx, draws)
                if names_p != names:
                    fail(f"{what}: {route} trains {len(names_p)} tensors, kernels {len(names)}")
                got[route] = (g, s)
            if launch_counts() != launched:
                fail(f"{what}: the plain routes launched kernels")
            loss = {r: float(s["loss_sum"]) / float(s["weight_sum"]) for r, (_, s) in got.items()}
            if not abs(loss["kernels"] - loss["plain"]) <= LOSS_RTOL * abs(loss["plain"]):
                fail(f"{what}: loss {loss} (kernels vs plain, rtol {LOSS_RTOL})")
            worst, worst_name = 0.0, ""
            for k, a, b in zip(names, g_k, got["plain"][0]):
                err = (a.float() - b.float()).abs().max().item()
                lim = STEP_GRAD_REL * b.float().abs().max().item() + 1e-6
                if err / lim > worst:
                    worst, worst_name = err / lim, k
                if not err <= lim:
                    fail(f"{what} gradient {k}: kernels vs plain max abs err {err:.3e} "
                         f"> {lim:.3e}")
            g32 = got["plain_f32"][0]
            dist = {r: rel_l2(got[r][0], g32) for r in ("kernels", "plain")}
            print(f"  {what}: loss kernels {loss['kernels']:.7f}, plain {loss['plain']:.7f}, "
                  f"plain f32 {loss['plain_f32']:.7f}; {len(names)} gradients, kernels vs "
                  f"plain the worst at {worst:.3f} of its bound ({worst_name}); relative L2 "
                  f"from plain f32: kernels {dist['kernels']:.3e}, plain bf16 "
                  f"{dist['plain']:.3e}", flush=True)
            res[kind][part] = {"loss": loss, "worst_share": worst,
                               "rel_l2_from_f32": dist}
        del kern, state, plain, states, got
        torch.cuda.empty_cache()
    print(json.dumps({"study_steps": res}), flush=True)
    return res


def rank_study_small() -> dict:
    """Phase 26 (a): ``bash tools/torch_rank_study.sh`` as a process, on
    the card, into a temporary directory at ``RANK_SMALL``'s scale, then
    ``tools/torch_summarize_rank_study.py`` on it: every stage exits 0, both
    pretrainings write ``best.ckpt``, and the summary has every k-NN, ridge,
    mean-pool k-NN and probe row, each in [0, 1]. Prints each stage's wall
    seconds. The study's CLIs run as processes of their own, each appending
    its launch counters at exit to ``SSRL_LAUNCH_LOG``
    (``ssrl_vit_mae_jepa_torch/scripts/__init__.py``); returns their sum,
    in which each kernel of ``RANK_KERNELS`` launched at least once. Then
    (b), ``study_steps`` on the config the study wrote."""
    tmp = REPO / "build" / f"tmp_rank_{os.getpid()}"
    out = tmp / "out"
    bin_dir = tmp / "bin"
    bin_dir.mkdir(parents=True)
    stub = bin_dir / "python"  # the study calls `python`: this interpreter
    stub.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    stub.chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k != "SSRL_TORCH_DEVICE"}
    launch_log = tmp / "launches.jsonl"
    env.update(RANK_SMALL, SSRL_RANK_OUT=str(out), SSRL_RANK_DATA=str(tmp / "data"),
               SSRL_LAUNCH_LOG=str(launch_log),
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(["bash", str(REPO / "tools" / "torch_rank_study.sh")],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        print(f"  bash tools/torch_rank_study.sh: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        log = out / "study.log"
        if proc.returncode != 0:
            tail = log.read_text(errors="replace")[-4000:] if log.exists() else ""
            fail(f"the rank study exited {proc.returncode}\n{proc.stderr[-2000:]}\n{tail}")
        for name in ("mae", "jepa"):
            ckpt = out / "outputs" / "pretrain" / f"rank_{name}" / "checkpoints" / "best.ckpt"
            if not ckpt.is_file():
                fail(f"the rank study wrote no {ckpt.relative_to(tmp)}")
        summ = subprocess.run([sys.executable, str(REPO / "tools" /
                                                   "torch_summarize_rank_study.py"), str(out)],
                              cwd=REPO, capture_output=True, text=True, timeout=120)
        if summ.returncode != 0:
            fail(f"torch_summarize_rank_study.py exited {summ.returncode}\n{summ.stdout}\n"
                 f"{summ.stderr}")
        lines = summ.stdout.strip().splitlines()
        stages, rows = json.loads(lines[0]), json.loads(lines[-1])
        processes = [json.loads(ln) for ln in launch_log.read_text().splitlines()]
        study_cfg = load_config(out / "study_cfg.yaml")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for stage, s in stages["stage_s"].items():
        print(f"  {stage}: {s} s wall", flush=True)
    print(f"  pretraining epochs: {json.dumps(stages['pretrain'])}", flush=True)
    got = {k: (rows[k] if k != "probes" else {n: p.get("best_val_acc")
                                              for n, p in rows[k].items()})
           for k in RANK_ROWS}
    for k, n in RANK_ROWS.items():
        vals = [v for v in got[k].values() if v is not None]
        if len(vals) != n or not all(0.0 <= v <= 1.0 for v in vals):
            fail(f"rank study summary: {k} has {got[k]}, expected {n} rows in [0, 1]")
    print(json.dumps({"rank_study_small": got}), flush=True)
    launches = dict.fromkeys(launch_counts(), 0)
    for proc_counts in processes:
        for k, v in proc_counts["launches"].items():
            launches[k] += v
    print(f"  {len(processes)} CLI processes, launches: "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    missing = [k for k in RANK_KERNELS if not launches[k]]
    if missing:
        fail(f"the rank study launched no {missing}")
    study_steps(study_cfg)
    return launches


def tp_cards(n: int) -> None:
    """``python3 chip_smoke.py --tp-cards N`` on a host with N cards: the
    build, then the flagship MAE, JEPA and full classifier steps (bf16,
    auto) at BATCH rows a data rank in the (N/2, 2) grid over ``nccl``, one
    process a card; beside them the same over N data ranks (``--dp-cards``'
    grid) and one card: each rank's ms/step and device ms/step, and exact
    TP launches per step; a ``{"tp_cards": ...}`` line before the last."""
    import tempfile

    if torch.cuda.device_count() < n or n % TP:
        fail(f"--tp-cards {n}: {torch.cuda.device_count()} cards, model axis {TP}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cards: {card()} x {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = load_config(REPO / "configs" / "mae.yaml")
    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    result = {}
    for name, mp in (("tp", TP), ("dp", 1)):
        with tempfile.TemporaryDirectory(dir=scratch) as tmp:
            ranks = tp_spawn(pathlib.Path(tmp), n, "nccl", mp, "timed", shared_card=False)
        result[name] = {"grid": ranks[0]["grid"]}
        for kind in ("mae", "jepa", "cls_full"):
            rk = [x[kind] for x in ranks]
            if mp > 1:
                want = expected(tp_launches(kind), STEPS)
                bad = [r for r, x in enumerate(rk) if x["launches"] != want]
                if bad:
                    fail(f"--tp-cards {kind}: ranks {bad} launched "
                         f"{nonzero(rk[bad[0]]['launches'])}, expected {tp_launches(kind)} "
                         f"a step")
            result[name][kind] = {"ms_per_rank": [x["ms"] for x in rk],
                                  "device_ms_per_rank": [x["device_ms"] for x in rk],
                                  "loss": rk[0]["loss"]}
    result["one_card"] = {}
    for kind in ("mae", "jepa", "cls_full"):
        task = tp_task(kind, cfg, torch.bfloat16, BATCH)
        state = task.init_state(0)
        batch, ctx = flagship_images(), task.epoch_context(0)
        ms = single_ms(task)
        dev = device_ms(lambda: task.train_step(state, batch, 0, ctx), iters=3)
        result["one_card"][kind] = {"ms": ms, "device_ms": dev}
        del task, state
        torch.cuda.empty_cache()
    for kind in ("mae", "jepa", "cls_full"):
        tp_, dp_, one = (result[g][kind] for g in ("tp", "dp", "one_card"))
        print(f"  {kind} at B={BATCH} a data rank: ({n // TP}, {TP}) grid "
              f"{max(tp_['ms_per_rank']):.3f} ms/step (slowest rank; device "
              f"{tp_['device_ms_per_rank']}), ({n}, 1) grid {max(dp_['ms_per_rank']):.3f} "
              f"(device {dp_['device_ms_per_rank']}), one card {one['ms']:.3f} (device "
              f"{one['device_ms']:.3f})", flush=True)
    print(json.dumps({"tp_cards": result, "card": card()}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


@contextlib.contextmanager
def timed_phase(times: dict, key: str, title: str):
    """Print the phase's title, run it, then print its wall time and keep it
    in ``times`` under ``key``."""
    print(f"phase {key}: {title}", flush=True)
    t0 = time.perf_counter()
    yield
    times[key] = round(time.perf_counter() - t0, 1)
    print(f"  phase {key}: {times[key]} s wall", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    times = {}
    print(f"phase 1: {card()}", flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")

    with timed_phase(times, "2", "build the kernels"):
        t0 = time.perf_counter()
        lib = _build.build()
        _build.load()
        print(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    with timed_phase(times, "3", "branch kernels vs plain versions (B=768, bf16)"):
        res = check_kernels()
        print("  the branch GEMM per product vs gemm_ref and torch.matmul", flush=True)
        print(json.dumps({"gemm_table": gemm_table()}), flush=True)
        print("  the LayerNorm backward alone (csrc/common.cuh) vs plain versions", flush=True)
        check_ln()
    with timed_phase(times, "3b", "attention kernels vs plain versions (B=768, bf16)"):
        res.update(check_attention())
    with timed_phase(times, "3c", "patch-embed kernels vs plain version (B=768, bf16)"):
        res.update(check_embed())
    with timed_phase(times, "3d", "MLP-half and whole-block kernels vs plain versions "
                     "(B=768, bf16)"):
        res.update(check_mlp_half())
        res.update(check_stack("block"))
    with timed_phase(times, "3e", "chained-block kernels vs plain version (B=768, bf16)"):
        res.update(check_stack("chain"))
    with timed_phase(times, "3f", "f32 branch forwards vs plain versions (TF32 off)"):
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
        with timed_phase(times, str(phase), f"MAE pretraining step, attn_impl={impl}"):
            counts, mae_ms[impl] = mae_step(model_cfg, name, impl)
            add(counts)
        with timed_phase(times, "5" if impl == "auto" else f"{phase} (B=16)",
                         f"B=16 step, attn_impl={impl}, kernels vs plain CPU path"):
            cpu_agreement(model_cfg, impl)
    with timed_phase(times, "8", "JEPA pretraining step, attn_impl=auto"):
        add(jepa_step(model_cfg, jepa_cfg, name, fused=False)[0])
    with timed_phase(times, "9", "JEPA and MAE steps with SSRL_FUSED_EMBED=1"):
        add(jepa_step(model_cfg, jepa_cfg, name, fused=True)[0])
        add(mae_step(model_cfg, name, "auto", fused=True)[0])
    with timed_phase(times, "10", "B=16 JEPA step, kernels vs plain CPU path"):
        jepa_cpu_agreement(model_cfg, jepa_cfg)
    for phase, impl in ((11, "block"), (12, "chain")):
        with timed_phase(times, str(phase), f"MAE pretraining step, attn_impl={impl}, then "
                         "B=16 kernels vs plain CPU path"):
            add(mae_step(model_cfg, name, impl)[0])
            cpu_agreement(model_cfg, impl)
    for phase, impl in ((13, "block"), (14, "chain")):
        with timed_phase(times, str(phase), f"JEPA pretraining step, attn_impl={impl}, then "
                         "B=16 kernels vs plain CPU path"):
            add(jepa_step(model_cfg, jepa_cfg, name, fused=False, impl=impl)[0])
            jepa_cpu_agreement(model_cfg, jepa_cfg, impl)
    train_cfg = {**cfg["train"], "batch_size": BATCH}
    with timed_phase(times, "15", "classifier step (full fine-tune, probe, unfreeze 2) and "
                     "eval step, attn_impl=auto"):
        add(classifier_steps(model_cfg, train_cfg, name)[0])
    with timed_phase(times, "16", "B=16 classifier steps and eval step, kernels vs plain "
                     "CPU path"):
        classifier_cpu_agreement(model_cfg, train_cfg)
    with timed_phase(times, "17", "the stage end to end: MAE fit, classifier fit from its "
                     "best.ckpt, test, resume"):
        add(stage_end_to_end(cfg, mae_ms["auto"]))
    with timed_phase(times, "18", "the CLIs on the card: pretrain, probe, evaluate, JEPA, "
                     "k-NN, features, reconstruction, ablation cells"):
        add(cli_end_to_end(cfg))
    with timed_phase(times, "19", "the lineage paths: MAE (augment off, SSRL_AUG_PATCHES=0, "
                     "dense loss), JEPA (augment off, dense loss), classifier full fine-tune "
                     "(augment off)"):
        counts, lineage_ms = lineage_paths(cfg, name)
        add(counts)
        print(json.dumps({"lineage_ms": lineage_ms}), flush=True)
    with timed_phase(times, "20", "data parallelism on the card: a one-rank nccl group, two "
                     "gloo ranks, pretrain_mae under torch.distributed.run"):
        add(data_parallel(cfg))
    with timed_phase(times, "21", "the bench's steady-state mode: the train step as a "
                     "CUDA-graph replay"):
        counts, fused_ms = fused_replay_process()
        add(counts)
        print(json.dumps({"fused_ms": fused_ms}), flush=True)
    with timed_phase(times, "22", "checkpoint fidelity: parity_check, run_parity_protocol, "
                     "convert_torch_checkpoint, a resume from a JAX-native checkpoint"):
        add(checkpoint_fidelity(cfg))
    with timed_phase(times, "23", "f32 training: the f32 kernels, the MAE, JEPA and "
                     "classifier steps at f32, Trainer.fit, fused replays"):
        f32_res, counts = f32_training(cfg, name)
        res.update(f32_res)
        add(counts)
    with timed_phase(times, "24", "f32 on block and chain with the fused embed: the f32 "
                     "whole block, chain and patch embed, the MAE, JEPA and classifier steps, "
                     "B=16 against the CPU, fused replays"):
        f32_res, counts = f32_stack_routes(cfg, name)
        res.update(f32_res)
        add(counts)
    with timed_phase(times, "25", "the tensor-parallel model axis: the TP entries at the shard "
                     "widths, two ranks in a (1, 2) grid against one process, a fit with a "
                     "checkpoint and a resume"):
        tp_res, counts = tensor_parallel(cfg)
        res.update(tp_res)
        add(counts)
    with timed_phase(times, "26", "the texture rank study at a small scale: "
                     "tools/torch_rank_study.sh (6,000 unlabeled, 1 epoch, B=2000), then "
                     "tools/torch_summarize_rank_study.py; the MAE and JEPA steps at B=2000 "
                     "and the partial batch, kernels against the plain route"):
        add(rank_study_small())

    rows = [(k, f"ssrl_vit_mae_jepa_torch/csrc/{src}", replaces)
            for k, (src, replaces, _) in KERNELS.items()]
    rows += [(f"{entry}_{pas}", "ssrl_vit_mae_jepa_torch/csrc/mha.cu", replaces)
             for entry, (*_, r_fwd, r_bwd, _) in ATTENTION.items()
             for pas, replaces in (("fwd", r_fwd), ("bwd", r_bwd))]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/patch_embed.cu", replaces)
             for k, replaces in EMBED_KERNELS.items()]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/block_mlp.cu", replaces)
             for k, replaces in HALF_KERNELS.items()]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/fused_block.cu", replaces)
             for k, replaces in BLOCK_KERNELS.items()]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/block_chain.cu", replaces)
             for k, replaces in CHAIN_KERNELS.items()]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/branch_f32.cu", replaces)
             for k, (_, replaces) in F32_KERNELS.items()]
    rows += [(k, "ssrl_vit_mae_jepa_torch/csrc/branch_f32.cu", replaces)
             for k, (_, replaces) in F32_TRAIN_KERNELS.items()]
    rows += [(f"{entry}_{pas}_f32", "ssrl_vit_mae_jepa_torch/csrc/mha_f32.cu", replaces)
             for entry, (*_, r_fwd, r_bwd, _) in ATTENTION.items()
             for pas, replaces in (("fwd", r_fwd), ("bwd", r_bwd))]
    rows += [(f"{k}_f32", f"ssrl_vit_mae_jepa_torch/csrc/{src}",
              {**BLOCK_KERNELS, **CHAIN_KERNELS, **EMBED_KERNELS}[k])
             for k, src in F32_STACK_SOURCES.items()]
    rows += [(f"{k}_f32", "ssrl_vit_mae_jepa_torch/csrc/block_mlp_f32.cu", replaces)
             for k, replaces in HALF_KERNELS.items()]
    rows += [(bf.dtype_key(dt, k), "ssrl_vit_mae_jepa_torch/csrc/"
              + (src if dt == torch.bfloat16 else "branch_f32.cu"), replaces)
             for dt in (torch.bfloat16, torch.float32)
             for k, (src, replaces) in TP_KERNELS.items()]
    kernels = []
    for k, src, replaces in rows:
        r = res[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **({"also_replaces": HALF_ALSO[k]} if k in HALF_ALSO else {}),
            **{kk: v for kk, v in r.items() if kk not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    times["total"] = round(time.perf_counter() - t_start, 1)
    print(json.dumps({"phase_s": times}), flush=True)
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(pathlib.Path(sys.argv[2]), sys.argv[3], sys.argv[4] == "timed")
    elif sys.argv[1:2] == ["--fused-replay"]:
        fused_replay_main(pathlib.Path(sys.argv[2]))
    elif sys.argv[1:2] == ["--f32-kernels"]:
        f32_kernels_main(sys.argv[2], pathlib.Path(sys.argv[3]))
    elif sys.argv[1:2] == ["--tp-kernels"]:
        tp_kernels_main(pathlib.Path(sys.argv[2]))
    elif sys.argv[1:2] == ["--dp-cards"]:
        dp_cards(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(pathlib.Path(sys.argv[2]), sys.argv[3], int(sys.argv[4]), sys.argv[5])
    elif sys.argv[1:2] == ["--tp-cards"]:
        tp_cards(int(sys.argv[2]))
    else:
        main()
