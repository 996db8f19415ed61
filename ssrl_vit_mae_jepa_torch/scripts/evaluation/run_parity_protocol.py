"""One-command checkpoint-parity protocol (the BASELINE.md fidelity claim) in
the port.

Port of ``scripts/evaluation/run_parity_protocol.py``: BASELINE.md's
accuracy target (STL-10 linear-probe top-1 within 0.5 points) is defined
against the reference checkpoints re-evaluated (reference
``download_weights.sh:1-8`` fetches them). For every ``*.pt`` / ``*.ckpt``
under the weights path:

1. **Golden check**: ``parity_check.check_file`` holds the port's f32
   models to the golden torch forward (encoder features, the whole MAE
   pipeline with the decoder, the classifier's logits); the port loads the
   reference names directly, so there is no conversion step.
2. **Probe re-evaluation**, where the file has a head: its test top-1
   through the port's stack (``scripts/utils.py::evaluate_checkpoint``, the
   bf16 eval step on the CLI's device) and through the golden forward on
   the same ``eval_transform`` batches, and the delta against the 0.5-pt
   bar.

Exit code 0 when every file passes both, 1 otherwise::

    ./download_weights.sh
    python -m ssrl_vit_mae_jepa_torch.scripts.evaluation.run_parity_protocol \\
        assets/weights --config configs/mae.yaml --data-dir data
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def _golden_probe_top1(golden_features, labels, weights, pool, head) -> tuple:
    """(correct, weight) sums of the golden classifier on golden features."""
    from ssrl_vit_mae_jepa_torch.scripts.evaluation.parity_check import golden_logits

    logits = golden_logits(golden_features, head, pool)
    correct = (logits.argmax(1) == labels).astype(np.float64) * weights
    return correct.sum(), weights.sum()


def evaluate_probe_delta(ckpt: Path, cfg: dict, data_dir) -> tuple:
    """(ours_top1, golden_top1) on the same eval-transformed test batches."""
    from ssrl_vit_mae_jepa_torch.data.loaders import get_test_dataloader
    from ssrl_vit_mae_jepa_torch.ops.augment import eval_transform
    from ssrl_vit_mae_jepa_torch.scripts.evaluation.parity_check import (
        encoder_state,
        head_weights,
        torch_forward_features,
    )
    from ssrl_vit_mae_jepa_torch.scripts.utils import device, evaluate_checkpoint
    from ssrl_vit_mae_jepa_torch.utils.load import load_any

    loader = get_test_dataloader(cfg, data_dir)
    ours = float(evaluate_checkpoint(cfg, ckpt, loader))

    model_cfg = cfg["model"]
    depth = model_cfg["encoder"]["depth"]
    heads = model_cfg["encoder"]["num_heads"]
    p = model_cfg["general"]["patch_size"]
    pool = model_cfg.get("head", {}).get("pool", "cls")
    _, flat, _ = load_any(ckpt)
    enc_state = encoder_state(flat)
    head = head_weights(flat)

    dev = device()
    c_sum = w_sum = 0.0
    for batch in loader.epoch(0):
        images = torch.from_numpy(batch["image"]).to(dev)
        imgs = eval_transform(images, out_size=model_cfg["general"]["image_size"],
                              dtype=torch.float32).cpu().numpy().transpose(0, 3, 1, 2)
        feats = torch_forward_features(enc_state, np.ascontiguousarray(imgs), depth, heads, p)
        c, w = _golden_probe_top1(feats, batch["label"], batch["weight"].astype(np.float64),
                                  pool, head)
        c_sum += c
        w_sum += w
    return ours, c_sum / max(w_sum, 1e-9)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        description="Golden-check and probe-re-evaluate reference checkpoints in the port "
        "against the BASELINE 0.5-pt parity bar")
    parser.add_argument("weights", type=str,
                        help="a .pt/.ckpt file or a directory of them (assets/weights)")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="dir containing stl10_binary/ (default: ./data or $SSRL_DATA_DIR)")
    parser.add_argument("--batch", type=int, default=8,
                        help="batch for the golden numeric checks")
    parser.add_argument("--tol", type=float, default=1e-3,
                        help="max-abs fp32 tolerance for golden checks")
    parser.add_argument("--bar", type=float, default=0.5,
                        help="probe top-1 parity bar in percentage points")
    args = parser.parse_args(argv)

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.scripts.evaluation.parity_check import check_file, head_weights
    from ssrl_vit_mae_jepa_torch.scripts.utils import setup_reproducibility, shut_down_warnings
    from ssrl_vit_mae_jepa_torch.utils.load import load_any

    shut_down_warnings()
    setup_reproducibility(seed=73)
    cfg = load_config(args.config)
    root = Path(args.weights)
    files = sorted([root] if root.is_file()
                   else [p for p in root.iterdir() if p.suffix in (".pt", ".ckpt")])
    if not files:
        raise SystemExit(f"❌ no .pt/.ckpt files under {root}")

    all_ok = True
    rows = []
    for f in files:
        print(f"\n━━ {f.name} ━━")
        try:
            ok = check_file(f, cfg, batch=args.batch, tol=args.tol)
        except SystemExit as e:
            print(e)
            ok = False
        row = {"file": f.name, "golden": ok}
        if ok and head_weights(load_any(f)[1]) is not None:
            ours, golden_acc = evaluate_probe_delta(f, cfg, args.data_dir)
            delta_pts = abs(ours - golden_acc) * 100.0
            row.update(ours_top1=ours, torch_top1=golden_acc, delta_pts=delta_pts,
                       within_bar=delta_pts <= args.bar)
            print(f"🎯 probe top-1: ours {ours:.4f} vs torch-golden {golden_acc:.4f} → "
                  f"Δ {delta_pts:.3f} pts (bar {args.bar}) "
                  f"{'✅' if row['within_bar'] else '❌'}")
            ok = ok and row["within_bar"]
        rows.append(row)
        all_ok = all_ok and ok

    print("\n━━ parity protocol summary ━━")
    for r in rows:
        bits = [f"golden={'OK' if r['golden'] else 'FAIL'}"]
        if "delta_pts" in r:
            bits.append(f"Δtop1={r['delta_pts']:.3f}pts {'OK' if r['within_bar'] else 'FAIL'}")
        print(f"  {r['file']}: " + ", ".join(bits))
    print("✅ PROTOCOL OK" if all_ok else "❌ PROTOCOL FAILED")
    if not all_ok:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
