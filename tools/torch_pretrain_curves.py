#!/usr/bin/env python3
"""The port's MAE and JEPA pretraining curves, run as the texture rank study
runs them, for one route and one dtype, and the rule that compares routes.

Each run is one pretraining of ``tools/torch_rank_study.sh``: the study's own
config (``outputs/torch_rank_study_h100/study_cfg.yaml``: 20 epochs, batch
2000, warmup 2, base lr 1.5e-4, val split 0.06) with ``seed: N`` added, on
the texture dataset (5000 train, 2000 test, 30000 unlabeled images, written
to ``--data_dir`` when it is not there yet), through the tasks and the
``Trainer`` exactly as ``scripts/training/pretrain_{mae,jepa}.py`` build
them, but with ``attn_impl`` and the task dtype given here (the CLIs take no
dtype). It runs no eval stage. Each run writes
``<out>/<method>_<attn-impl>_<dtype>_s<seed>.json`` with every epoch's
metrics (the records of the trainer's ``metrics.jsonl``) and the card's
name and power limit. At ``float32`` TF32 is switched off for matmuls and
convolutions, so the run is an f32 reference. Runs on the card unless
``SSRL_TORCH_DEVICE=cpu``::

    python3 tools/torch_pretrain_curves.py --seed 73 74 --attn-impl auto \\
        --dtype float32 --out outputs/torch_rank_study_h100/curves

``--summarize DIR`` reads the runs in DIR (and the study's plain bf16
pretrainings of ``outputs/torch_rank_study_h100/seeds/xla_s*``, for seeds
without a plain bf16 run of their own), prints one table per method of the
last epoch's ``val_loss`` on the three routes and applies the decision
rule: the bf16 kernel route (``auto``, V_k) is faulty for a method when
V_k > V_p (plain bf16, ``xla``) at all seeds but at most one, and
mean(V_k - V_32) > 2 mean(|V_p - V_32|), V_32 the f32 kernel route.

It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

STUDY = REPO / "outputs" / "torch_rank_study_h100"
METHODS = ("mae", "jepa")
DTYPES = ("bfloat16", "float32")
# the texture dataset of tools/torch_rank_study.sh (card scale)
DATA_SIZES = {"num_train": 5000, "num_test": 2000, "num_unlabeled": 30000}


def ensure_data(data_dir: Path) -> None:
    from ssrl_vit_mae_jepa_torch.data.stl10 import write_synthetic_stl10

    if not (data_dir / "stl10_binary" / "unlabeled_X.bin").exists():
        t0 = time.time()
        write_synthetic_stl10(data_dir, class_signal="texture", **DATA_SIZES)
        print(f"texture dataset written to {data_dir} in {time.time() - t0:.1f}s", flush=True)


def run_one(cfg_path: Path, data_dir: Path, method: str, seed: int, impl: str,
            dtype_name: str, out: Path) -> dict:
    """One pretraining as the CLI makes it; returns the JSON it writes."""
    import torch

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.data.loaders import get_pretrain_dataloaders
    from ssrl_vit_mae_jepa_torch.scripts.utils import device, setup_reproducibility
    from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
    from ssrl_vit_mae_jepa_torch.training.tasks import MAETask
    from ssrl_vit_mae_jepa_torch.training.trainer import Trainer

    from chip_smoke import card

    setup_reproducibility(seed=73)  # as the CLIs: the fit's own seed is cfg["seed"]
    cfg = load_config(cfg_path)
    cfg["seed"] = seed
    dtype = getattr(torch, dtype_name)
    dev = device()
    if method == "mae":
        task_cfg = cfg["pretrain"]
        task = MAETask(cfg["model"], task_cfg, dtype=dtype, device=dev, attn_impl=impl)
    else:
        task_cfg = cfg["jepa"]
        task = JEPATask(cfg["model"], task_cfg, dtype=dtype, device=dev, attn_impl=impl)
    name = f"{method}_{impl}_{dtype_name}_s{seed}"
    print(f"=== {name} ({task_cfg['total_epochs']} ep, batch {task_cfg['batch_size']}) "
          f"on {dev} ===", flush=True)
    train_loader, val_loader = get_pretrain_dataloaders(cfg, data_dir)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        trainer = Trainer(task, max_epochs=task_cfg["total_epochs"], output_dir=tmp,
                          seed=cfg["seed"],
                          log_every_n_steps=cfg["logging"].get("log_every_n_steps"),
                          hyper_parameters={"model_cfg": cfg["model"],
                                            "training_cfg": task_cfg})
        t0 = time.time()
        trainer.fit(train_loader, val_loader)
        wall = time.time() - t0
        trainer.logger.close()
        records = [json.loads(line)
                   for line in trainer.logger.jsonl_path.read_text().splitlines()]
    result = {
        "method": method, "attn_impl": impl, "dtype": dtype_name, "seed": seed,
        "device": str(dev), "card": card() if dev.startswith("cuda") else "cpu",
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "config": os.path.relpath(cfg_path, REPO), "fit_s": wall,
        "epochs": [r for r in records if "val_loss" in r],
    }
    (out / f"{name}.json").write_text(json.dumps(result, indent=1) + "\n")
    return result


def run(args) -> int:
    import torch

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.dtype == "float32":  # an f32 reference: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data_dir = Path(args.data_dir)
    ensure_data(data_dir)
    for seed in args.seed:
        for method in args.method:
            r = run_one(Path(args.config), data_dir, method, seed, args.attn_impl,
                        args.dtype, out)
            print(json.dumps({"run": f"{method}_{args.attn_impl}_{args.dtype}_s{seed}",
                              "val_loss": r["epochs"][-1]["val_loss"],
                              "fit_s": r["fit_s"]}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the decision rule
# ---------------------------------------------------------------------------


def last_val_loss(records: list) -> float:
    return [r for r in records if "val_loss" in r][-1]["val_loss"]


def study_val_loss(seed: int, method: str):
    """The last ``val_loss`` of the study's own plain bf16 pretraining
    (``tools/torch_rank_study.sh`` with ``SSRL_TORCH_ATTN_IMPL=xla``)."""
    path = STUDY / "seeds" / f"xla_s{seed}" / "outputs" / "pretrain" / f"rank_{method}" \
        / "metrics.jsonl"
    if not path.exists():
        return None
    return last_val_loss([json.loads(line) for line in path.read_text().splitlines()])


def rule(rows: list) -> dict:
    """``rows``: (seed, V_k, V_p, V_32) with every value present."""
    n = len(rows)
    if n == 0:
        return {"seeds": 0, "fires": None}
    above = sum(vk > vp for _, vk, vp, _ in rows)
    drift_k = statistics.mean(vk - v32 for _, vk, _, v32 in rows)
    spread_p = statistics.mean(abs(vp - v32) for _, _, vp, v32 in rows)
    fires = above >= n - 1 and drift_k > 2 * spread_p
    return {"seeds": n, "k_above_p": above, "needed": n - 1,
            "mean_k_minus_32": drift_k, "mean_abs_p_minus_32": spread_p,
            "fires": fires}


def summarize(directory: Path) -> int:
    runs = {}
    for path in sorted(directory.glob("*_s*.json")):
        r = json.loads(path.read_text())
        runs[(r["method"], r["attn_impl"], r["dtype"], r["seed"])] = r
    out = {}
    for method in METHODS:
        seeds = sorted({k[3] for k in runs if k[0] == method})
        rows, table = [], []
        for seed in seeds:
            get = lambda impl, dt: runs.get((method, impl, dt, seed))  # noqa: E731
            vk = get("auto", "bfloat16")
            v32 = get("auto", "float32")
            vp = get("xla", "bfloat16")
            vp_study = study_val_loss(seed, method)
            vk, v32 = (last_val_loss(r["epochs"]) if r else None for r in (vk, v32))
            vp_run = last_val_loss(vp["epochs"]) if vp else None
            vp = vp_run if vp_run is not None else vp_study
            plain32 = get("xla", "float32")
            table.append({"seed": seed, "V_k": vk, "V_p": vp, "V_32": v32,
                          "V_p_study": vp_study, "V_p_rerun": vp_run,
                          "plain_f32": last_val_loss(plain32["epochs"]) if plain32 else None})
            if None not in (vk, vp, v32):
                rows.append((seed, vk, vp, v32))
        out[method] = {"table": table, "rule": rule(rows)}
        print(f"\n{method}: last epoch's val_loss")
        print("| seed | V_k (auto bf16) | V_p (xla bf16) | V_32 (auto f32) | V_k - V_32 "
              "| V_p - V_32 | plain f32 |")
        print("|---|---|---|---|---|---|---|")
        for t in table:
            diff = lambda a, b: f"{a - b:+.5f}" if None not in (a, b) else ""  # noqa: E731
            cell = lambda v: f"{v:.5f}" if v is not None else ""  # noqa: E731
            print(f"| {t['seed']} | {cell(t['V_k'])} | {cell(t['V_p'])} | {cell(t['V_32'])} "
                  f"| {diff(t['V_k'], t['V_32'])} | {diff(t['V_p'], t['V_32'])} "
                  f"| {cell(t['plain_f32'])} |")
        print(json.dumps({method: out[method]["rule"]}))
    (directory / "summary.json").write_text(json.dumps(out, indent=1) + "\n")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, nargs="+", default=[73])
    parser.add_argument("--method", choices=METHODS, nargs="+", default=list(METHODS))
    parser.add_argument("--attn-impl", default="auto")
    parser.add_argument("--dtype", choices=DTYPES, default="bfloat16")
    parser.add_argument("--config", default=str(STUDY / "study_cfg.yaml"))
    parser.add_argument("--data_dir", default=str(REPO / "build" / "texture_data"))
    parser.add_argument("--out", default=str(STUDY / "curves"))
    parser.add_argument("--summarize", metavar="DIR", default=None)
    args = parser.parse_args(argv)
    if args.summarize:
        return summarize(Path(args.summarize))
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
