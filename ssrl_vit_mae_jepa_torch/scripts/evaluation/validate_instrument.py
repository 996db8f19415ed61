"""Validate the texture synthetic dataset as a representation instrument
(port of ``scripts/evaluation/validate_instrument.py``).

The round-3 study showed the default "linear" synthetic class signal is
decodable by any mean-preserving map, so frozen-representation evals
saturate (a random encoder probes/k-NNs to 100%) and cannot rank MAE vs
JEPA. The "texture" signal (``data/stl10.py:_texture_images``) moves class
identity into phase-invariant spectral energy. This script measures the
instrument's floor and ceiling on a texture dataset:

- **floor** — decoders that must sit near chance (10%) for the instrument
  to be valid: a closed-form ridge probe on raw pixels, soft-vote cosine
  k-NN on raw pixels, and both on a frozen seed-73 random-init encoder;
- **ceiling** — a decoder that must score high: the quadrature matched
  filter (oracle access to the class spectra — the Bayes-style upper
  reference), plus optionally a supervised flagship ViT trained for
  ``--supervised-steps`` (the "reachable by a trained encoder" ceiling).

No reference counterpart (the reference trains on real STL-10); this is
framework surface for the zero-egress environment. Prints one JSON line
with every row so CI and RESULTS.md can cite it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

import torch

from ssrl_vit_mae_jepa_torch.scripts.utils import (
    device,
    setup_reproducibility,
    shut_down_warnings,
)


def ridge_probe(train_x, train_y, test_x, lam=1e3, num_classes=10):
    """Closed-form kernel ridge on one-hot targets (dual form: the pixel
    dimension is 27k, so solve the (n, n) system instead)."""
    x = train_x.astype(np.float64)
    x = x - x.mean(axis=0)
    t = test_x.astype(np.float64) - train_x.astype(np.float64).mean(axis=0)
    y = np.eye(num_classes)[train_y]
    k = x @ x.T
    alpha = np.linalg.solve(k + lam * np.eye(len(x)), y)
    return (t @ x.T @ alpha).argmax(axis=1)


def matched_filter_oracle(images_u8, num_classes=10, size=96):
    """Quadrature spectral-energy classifier with oracle class parameters
    (orientation pi*(c%5)/5, frequency 6/12, harmonics 1..3 — the exact
    generator spec in data/stl10.py:_texture_images).

    Coordinate frame: the STL-10 binary stores (C, W, H) column-major, so
    ``images_nhwc`` presents the generator's rows as columns — the
    projection axes swap relative to the generator formula (a pure
    relabeling; measured 91% vs 4.7% in the wrong frame)."""
    lum = images_u8.reshape(len(images_u8), size, size, 3).astype(
        np.float64
    ).mean(-1)
    lum = lum - lum.mean(axis=(1, 2), keepdims=True)
    yy, xx = np.meshgrid(
        np.arange(size, dtype=np.float64) / size,
        np.arange(size, dtype=np.float64) / size,
        indexing="ij",
    )
    energies = np.zeros((len(lum), num_classes))
    for c in range(num_classes):
        theta = np.pi * (c % 5) / 5.0
        freq = 6.0 if c < 5 else 12.0
        proj = np.cos(theta) * yy + np.sin(theta) * xx
        for h in (1, 2, 3):
            ang = 2 * np.pi * freq * h * proj
            cosb, sinb = np.cos(ang), np.sin(ang)
            e = (
                np.tensordot(lum, cosb, axes=([1, 2], [0, 1])) ** 2
                + np.tensordot(lum, sinb, axes=([1, 2], [0, 1])) ** 2
            )
            energies[:, c] += e
    return energies.argmax(axis=1)


def supervised_ceiling(cfg, tr, tr_idx, tr_y, te, te_idx, te_y, steps: int,
                       batch_size: int) -> float:
    """Train the flagship ViT classifier (bf16) supervised for ``steps``
    steps at batch 64 (AdamW, lr 1e-3, wd 0.05, no augmentation, pixels in
    [0, 1]) and return its test accuracy: the reachable ceiling."""
    import torch.nn.functional as F

    from ssrl_vit_mae_jepa_torch.models.classifier import classifier_from_config

    dev = device()
    model = classifier_from_config(cfg["model"], dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(tr.images_nhwc(tr_idx).astype(np.float32) / 255.0)
    ys = torch.from_numpy(np.asarray(tr_y)).long()
    for _ in range(steps):
        b = torch.from_numpy(rng.integers(0, len(tr_idx), 64))
        loss = F.cross_entropy(model(xs[b].to(dev)).float(), ys[b].to(dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    correct = 0
    tex = te.images_nhwc(te_idx).astype(np.float32) / 255.0
    with torch.no_grad():
        for lo in range(0, len(te_idx), batch_size):
            x = torch.from_numpy(tex[lo:lo + batch_size]).to(dev)
            pred = model(x).argmax(-1).cpu().numpy()
            correct += int((pred == te_y[lo:lo + batch_size]).sum())
    return correct / len(te_idx)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/mae.yaml")
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--train", type=int, default=1000)
    ap.add_argument("--test", type=int, default=500)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=200)
    ap.add_argument(
        "--supervised-steps", type=int, default=0,
        help="also train the flagship ViT supervised for N steps at batch "
        "64 and report its test accuracy (the reachable ceiling); 0 = skip",
    )
    args = ap.parse_args(argv)
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.data.loaders import default_data_dir
    from ssrl_vit_mae_jepa_torch.data.stl10 import STL10
    from ssrl_vit_mae_jepa_torch.scripts.evaluation.knn_eval import (
        knn_predict,
        random_encoder_features,
    )

    cfg = load_config(args.config)
    data_dir = args.data_dir or default_data_dir()
    tr = STL10(data_dir, "train")
    te = STL10(data_dir, "test")
    tr_idx = np.arange(min(args.train, len(tr)))
    te_idx = np.arange(min(args.test, len(te)))
    tr_x = tr.images_nhwc(tr_idx).reshape(len(tr_idx), -1)
    te_x = te.images_nhwc(te_idx).reshape(len(te_idx), -1)
    tr_y, te_y = tr.labels[tr_idx], te.labels[te_idx]

    rows = {}
    rows["pixel_ridge_probe"] = float(
        (ridge_probe(tr_x, tr_y, te_x) == te_y).mean()
    )
    rows["pixel_knn"] = float(
        (knn_predict(tr_x.astype(np.float32), tr_y, te_x.astype(np.float32),
                     k=args.k) == te_y).mean()
    )
    rf_tr, rl_tr = random_encoder_features(
        cfg, "cls", "train", args.batch_size, data_dir
    )
    rf_te, rl_te = random_encoder_features(
        cfg, "cls", "test", args.batch_size, data_dir
    )
    rf_tr, rl_tr = rf_tr[tr_idx], rl_tr[tr_idx]
    rf_te, rl_te = rf_te[te_idx], rl_te[te_idx]
    rows["random_encoder_ridge_probe"] = float(
        (ridge_probe(rf_tr, rl_tr, rf_te, lam=10.0) == rl_te).mean()
    )
    rows["random_encoder_knn"] = float(
        (knn_predict(rf_tr, rl_tr, rf_te, k=args.k) == rl_te).mean()
    )
    rows["matched_filter_oracle"] = float(
        (matched_filter_oracle(te.images_nhwc(te_idx)) == te_y).mean()
    )

    if args.supervised_steps:
        rows["supervised_vit"] = supervised_ceiling(
            cfg, tr, tr_idx, tr_y, te, te_idx, te_y, args.supervised_steps,
            args.batch_size)

    print(json.dumps({"n_train": len(tr_idx), "n_test": len(te_idx), **rows}))
    # Gate on the k-NN floor — the eval the ranking study leans on. The
    # ridge rows are reported but NOT gated at chance: matched class means
    # do not block a linear-argmax readout from exploiting class-dependent
    # VARIANCE (score_c = w_c·x has mean 0 for every class but a larger
    # variance when w_c aligns with class c's spectral subspace, so argmax
    # picks c disproportionately) — measured ~29% on pixels / ~36% on
    # random-encoder features. That channel caps well below the trained
    # ceiling; the instrument's dynamic range is the gap.
    floor_ok = (
        rows["pixel_knn"] < 0.25
        and rows["random_encoder_knn"] < 0.25
        and rows["pixel_ridge_probe"] < 0.5
        and rows["random_encoder_ridge_probe"] < 0.5
    )
    ceiling_ok = rows["matched_filter_oracle"] > 0.8
    print(f"floor {'OK' if floor_ok else 'SATURATED'} / "
          f"ceiling {'OK' if ceiling_ok else 'UNREACHABLE'}")
    return 0 if (floor_ok and ceiling_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
