"""Training-step throughput benchmark of the port (``bench.py``'s counterpart).

Measures images/s of the whole training step on the card: uint8
augmentation → masks → encoder/decoder forward and backward → clipped
AdamW update, at the flagship geometry (ViT enc 144/4/6, dec 192/2/6,
96 px, patch 8, mask 0.75, bf16), for MAE, JEPA or the classifier's full
fine-tune. ``--fused`` times ``Task.train_steps_fused``: the step captured
once in a CUDA graph and replayed ``--steps`` times, the steady-state
device rate without the host's per-step launch work. The batch is
``np.random.default_rng(0)``'s uint8 images, as in ``bench.py``.

Run on the card (unset ``SSRL_TORCH_DEVICE``)::

    python -m ssrl_vit_mae_jepa_torch.bench --task mae --fused
    python -m ssrl_vit_mae_jepa_torch.bench --task jepa --fused --profile-dir prof/

and, as a smoke test on the CPU, ``SSRL_TORCH_DEVICE=cpu python -m
ssrl_vit_mae_jepa_torch.bench --tiny --batch-size 8 --steps 2 --warmup 1``.
Under ``python -m torch.distributed.run`` ``--batch-size`` is the global
batch, split over the ranks; ``chips`` is the world size and rank 0
prints. Peak device memory and, with ``--profile-dir``, the kernels' table
come on lines of their own; the last line is one JSON object with
``bench.py``'s keys. A capture or kernel failure raises: nothing falls
back to eager steps or to the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

BASELINE_IMAGES_PER_S = 11900.0

TINY_MODEL = {
    "general": {"image_size": 96, "patch_size": 8, "in_chans": 3},
    "encoder": {"embed_dim": 32, "depth": 2, "num_heads": 4},
    "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4},
    "head": {"pool": "cls"},
}
TINY_JEPA = {"predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--task", type=str, default="mae", choices=["mae", "jepa", "classifier"],
                        help="which training step to benchmark (headline metric: mae)")
    parser.add_argument("--batch-size", type=int, default=768)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--fused", action=argparse.BooleanOptionalAction, default=False,
                        help="time all --steps as replays of one captured CUDA graph "
                        "(steady-state device rate; removes the per-step host work)")
    parser.add_argument("--attn-impl", type=str, default="auto")
    parser.add_argument("--augment", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="capture a torch.profiler trace of the timed steps into this dir")
    parser.add_argument("--tiny", action="store_true",
                        help="shrink the model for smoke testing (CI import/arg regression "
                        "checks on slow hosts): NOT a performance configuration")
    return parser.parse_args(argv)


def make_task(args, device: str):
    """The task and settings of ``bench.py:81-95``."""
    from ssrl_vit_mae_jepa_torch.config import DEFAULTS
    from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
    from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask

    B = args.batch_size
    model_cfg, jepa_base = DEFAULTS["model"], DEFAULTS["jepa"]
    if args.tiny:
        model_cfg, jepa_base = TINY_MODEL, {**jepa_base, **TINY_JEPA}
    pre_cfg = {
        "mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
        "total_epochs": 800, "warmup_epochs": 20, "batch_size": B,
        "base_learning_rate": 1.5e-4, "weight_decay": 0.05, "augment": args.augment,
    }
    if args.task == "mae":
        return MAETask(model_cfg, pre_cfg, device=device, attn_impl=args.attn_impl)
    if args.task == "jepa":
        jepa_cfg = {**jepa_base, "batch_size": B, "augment": args.augment}
        return JEPATask(model_cfg, jepa_cfg, device=device, attn_impl=args.attn_impl)
    train_cfg = {**DEFAULTS["train"], "batch_size": B, "freeze_encoder": False}
    return ClassifierTask(model_cfg, train_cfg, device=device, attn_impl=args.attn_impl,
                          augment=args.augment)


def make_batch(B: int, rank: int, ranks: int, device: str) -> dict:
    """``bench.py``'s batch: B uint8 images and labels from
    ``np.random.default_rng(0)``, unit weights; this rank's rows of it."""
    if B % ranks:
        raise ValueError(f"--batch-size {B} does not split over {ranks} ranks")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, 96, 96, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, B).astype(np.int32)
    rows = slice(rank * (B // ranks), (rank + 1) * (B // ranks))
    return {"image": torch.from_numpy(images[rows]).to(device),
            "label": torch.from_numpy(labels[rows]).to(device),
            "weight": torch.ones(B // ranks, device=device)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ssrl_vit_mae_jepa_torch.parallel.mesh import get_mesh
    from ssrl_vit_mae_jepa_torch.scripts.utils import device, init_distributed
    from ssrl_vit_mae_jepa_torch.utils.flops import peak_flops_per_chip, task_flops_per_image
    from ssrl_vit_mae_jepa_torch.utils.profiling import device_step_ms, op_table, trace

    init_distributed()
    dev = device()
    on_card = dev.startswith("cuda")
    grid = get_mesh()
    axis = grid.data  # the batch splits over the data ranks
    rank, ranks = (axis.rank, axis.size) if axis is not None else (0, 1)
    task = make_task(args, dev)
    task.configure_sharding(grid)
    state = task.init_state(0)
    batch = make_batch(args.batch_size, rank, ranks, dev)
    ctx = task.epoch_context(0)

    def sync(sums):
        float(sums["loss_sum"])  # the last step's value: every step before it is done
        if on_card:
            torch.cuda.synchronize(dev)

    for _ in range(args.warmup):
        state, sums = task.train_step(state, batch, 0, ctx)
    sync(sums)
    if args.fused:
        # capture (and one eager step) outside the timed region
        state, sums = task.train_steps_fused(state, batch, 0, ctx, args.steps)
        sync(sums)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    with trace(args.profile_dir) as prof:
        t0 = time.perf_counter()
        if on_card:
            start.record()
        if args.fused:
            state, sums = task.train_steps_fused(state, batch, 0, ctx, args.steps)
        else:
            for _ in range(args.steps):
                state, sums = task.train_step(state, batch, 0, ctx)
        if on_card:
            end.record()
        sync(sums)
        dt = start.elapsed_time(end) / 1e3 if on_card else time.perf_counter() - t0

    B = args.batch_size
    images_per_s = B * args.steps / dt
    platform = "gpu" if on_card else "cpu"
    flops_per_image = task_flops_per_image(task, ctx)
    peak = peak_flops_per_chip(torch.cuda.get_device_name(dev) if on_card else platform)
    mfu = round(flops_per_image * images_per_s / (ranks * peak), 4) if peak else None
    dev_ms = device_step_ms(prof, args.steps) if prof is not None else None
    result = {
        "metric": f"{args.task}_pretrain_images_per_sec"
        if args.task != "classifier" else "classifier_train_images_per_sec",
        "value": round(images_per_s, 1),
        "unit": "images/s",
        # against the reference's MAE number for every task, as bench.py
        "vs_baseline": round(images_per_s / BASELINE_IMAGES_PER_S, 3),
        "batch_size": B,
        "steps": args.steps,
        "dispatch": "fused" if args.fused else "per-step",
        "chips": ranks,
        "images_per_sec_per_chip": round(images_per_s / ranks, 1),
        "step_time_ms": round(1e3 * dt / args.steps, 3),
        "platform": platform,
        "flops_per_image": flops_per_image,
        "peak_tflops": round(peak / 1e12, 1) if peak else None,
        "mfu": mfu,
        "device_step_ms": round(dev_ms, 3) if dev_ms else None,
    }
    if rank == 0:
        if on_card:
            print(json.dumps({"peak_memory_gib": round(
                torch.cuda.max_memory_allocated(dev) / 2**30, 3)}))
        if prof is not None:
            print(json.dumps({"op_table": op_table(prof, args.steps)}))
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
