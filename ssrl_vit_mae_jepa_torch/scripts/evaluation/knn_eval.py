"""k-NN classification on frozen encoder features (port of
``scripts/evaluation/knn_eval.py``).

Soft-vote cosine k-NN (DINO/I-JEPA style): l2-normalized features of the
labeled train split vote for each test image, weighted by exp(sim/T) over
the top-k neighbours; ``--eval ridge`` adds the closed-form ridge probe of
``validate_instrument``. Features come from an encoder checkpoint, a
seed-73 random-init encoder (``random``) or raw pixels (``pixels``); the
encoders run at f32 under ``torch.no_grad()`` (the f32 branch kernels on
the card). ``knn_predict`` is numpy and is copied from the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.scripts.utils import (
    device,
    setup_reproducibility,
    shut_down_warnings,
)


def knn_predict(
    train_feats: np.ndarray,
    train_labels: np.ndarray,
    test_feats: np.ndarray,
    k: int = 20,
    temperature: float = 0.07,
    num_classes: int = 10,
) -> np.ndarray:
    """Soft-vote cosine k-NN: (N_test,) predicted labels."""

    def _l2(x):
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)

    tr = _l2(train_feats.astype(np.float32))
    te = _l2(test_feats.astype(np.float32))
    sims = te @ tr.T  # (N_test, N_train) cosine similarities
    k = min(k, tr.shape[0])
    nn_idx = np.argpartition(-sims, k - 1, axis=1)[:, :k]
    nn_sims = np.take_along_axis(sims, nn_idx, axis=1)
    nn_lab = train_labels[nn_idx]
    w = np.exp(nn_sims / temperature)
    votes = np.zeros((te.shape[0], num_classes), np.float64)
    for c in range(num_classes):
        votes[:, c] = np.where(nn_lab == c, w, 0.0).sum(axis=1)
    return votes.argmax(axis=1)


def random_encoder_features(cfg, pool, split, batch_size, data_dir):
    """Features from a seed-73 random-init f32 encoder (no checkpoint)."""
    from ssrl_vit_mae_jepa_torch.models.vit import vit_from_config
    from ssrl_vit_mae_jepa_torch.scripts.evaluation.visualize_representation import (
        encoder_features,
    )

    vit = vit_from_config(cfg["model"], dtype=torch.float32)
    vit.init_weights(torch.Generator().manual_seed(73))
    vit.to(device()).eval()
    return encoder_features(vit, pool, split, batch_size, data_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/mae.yaml")
    ap.add_argument("--checkpoint", required=True,
                    help="encoder checkpoint (.ckpt/.pt), or 'random' for a seed-73 "
                         "random-init baseline, or 'pixels' for raw-pixel k-NN")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--temperature", type=float, default=0.07)
    ap.add_argument("--pool", choices=["cls", "mean"], default="cls")
    ap.add_argument("--samples_per_class", type=int, default=0,
                    help="cap the train reference set (0 = all 5000)")
    ap.add_argument("--batch_size", type=int, default=500)
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--eval", choices=["knn", "ridge", "both"], default="knn",
                    help="'ridge' adds the closed-form ridge probe from validate_instrument")
    ap.add_argument("--ridge_lam", type=float, default=10.0)
    args = ap.parse_args(argv)
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config

    cfg = load_config(args.config)
    if args.checkpoint == "pixels":
        from ssrl_vit_mae_jepa_torch.data.loaders import default_data_dir
        from ssrl_vit_mae_jepa_torch.data.stl10 import STL10

        def _flat(split):
            ds = STL10(args.data_dir or default_data_dir(), split)
            imgs = ds.images_nhwc(np.arange(len(ds))).astype(np.float32)
            return imgs.reshape(len(ds), -1), ds.labels

        tr_f, tr_y = _flat("train")
        te_f, te_y = _flat("test")
    elif args.checkpoint == "random":
        tr_f, tr_y = random_encoder_features(cfg, args.pool, "train", args.batch_size,
                                             args.data_dir)
        te_f, te_y = random_encoder_features(cfg, args.pool, "test", args.batch_size,
                                             args.data_dir)
    else:
        from ssrl_vit_mae_jepa_torch.scripts.evaluation.visualize_representation import (
            extract_features,
        )

        tr_f, tr_y = extract_features(cfg, args.checkpoint, pool=args.pool, split="train",
                                      batch_size=args.batch_size, data_dir=args.data_dir)
        te_f, te_y = extract_features(cfg, args.checkpoint, pool=args.pool, split="test",
                                      batch_size=args.batch_size, data_dir=args.data_dir)

    if args.samples_per_class:
        from ssrl_vit_mae_jepa_torch.data.stl10 import stratified_split_indices

        idx, _ = stratified_split_indices(tr_y, args.samples_per_class, seed=73)
        tr_f, tr_y = tr_f[idx], tr_y[idx]

    acc = None
    if args.eval in ("knn", "both"):
        pred = knn_predict(tr_f, tr_y, te_f, k=args.k, temperature=args.temperature)
        acc = float((pred == te_y).mean())
        print(f"kNN(k={args.k}, T={args.temperature}, pool={args.pool}, "
              f"train={len(tr_y)}) test accuracy: {acc:.4f}")
    if args.eval in ("ridge", "both"):
        from ssrl_vit_mae_jepa_torch.scripts.evaluation.validate_instrument import ridge_probe

        pred = ridge_probe(tr_f, tr_y, te_f, lam=args.ridge_lam)
        racc = float((pred == te_y).mean())
        print(f"ridge(lam={args.ridge_lam:g}, pool={args.pool}, train={len(tr_y)}) "
              f"test accuracy: {racc:.4f}")
        acc = racc if acc is None else acc
    return acc


if __name__ == "__main__":
    main()
