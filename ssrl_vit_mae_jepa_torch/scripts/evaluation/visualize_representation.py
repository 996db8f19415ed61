"""Embedding-space visualizer: UMAP / t-SNE projections of encoder features
(port of ``scripts/evaluation/visualize_representation.py``).

Loads an encoder with prefix detection and extracts features at f32 under
``torch.no_grad()`` (on the card the blocks run the f32 branch kernels of
``csrc/branch_f32.cu``), pooled ``cls`` or ``mean`` (the mean EXCLUDES the
CLS token here, quirk Q6) and normalized ``none`` / ``l2`` / ``channel``;
projects them to 2-D with UMAP (umap-learn when installed, else the numpy
copy ``utils/umap_np.py``) or t-SNE (sklearn), and saves a global scatter
plus 10 class-vs-rest plots to ``assets/visualizations/``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.scripts.utils import (
    device,
    setup_reproducibility,
    shut_down_warnings,
)


@torch.no_grad()
def encoder_features(vit, pool: str, split: str, batch_size: int, data_dir=None):
    """(features, labels) of the STL-10 split through ``vit`` (on its
    device, in its dtype): the CLS token or the mean of the patch tokens."""
    from ssrl_vit_mae_jepa_torch.data.loaders import default_data_dir
    from ssrl_vit_mae_jepa_torch.data.stl10 import STL10
    from ssrl_vit_mae_jepa_torch.ops.augment import eval_transform

    dev = vit.cls_token.device
    ds = STL10(data_dir or default_data_dir(), split)
    feats, labels = [], []
    for start in range(0, len(ds), batch_size):
        idx = np.arange(start, min(start + batch_size, len(ds)))
        images = torch.from_numpy(ds.images_nhwc(idx)).to(dev)
        tokens = vit(eval_transform(images, out_size=vit.img_size, dtype=torch.float32))
        f = tokens[:, 0] if pool == "cls" else tokens[:, 1:].mean(dim=1)
        feats.append(f.float().cpu().numpy())
        labels.append(ds.labels[idx])
    return np.concatenate(feats), np.concatenate(labels)


def normalize_features(feats: np.ndarray, normalize: str) -> np.ndarray:
    if normalize == "l2":
        return feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-8)
    if normalize == "channel":
        return (feats - feats.mean(0)) / np.maximum(feats.std(0), 1e-8)
    return feats


def extract_features(cfg, checkpoint, pool="cls", normalize="none", split="train",
                     batch_size=256, data_dir=None):
    """The encoder of ``checkpoint`` at f32 over a split → (features, labels)."""
    from ssrl_vit_mae_jepa_torch.models.vit import vit_from_config
    from ssrl_vit_mae_jepa_torch.utils.load import encoder_params_from_checkpoint

    model_cfg = cfg["model"]
    vit = vit_from_config(model_cfg, dtype=torch.float32)
    enc, _ = encoder_params_from_checkpoint(checkpoint, model_cfg["encoder"]["depth"])
    vit.load_state_dict(enc, strict=True)
    vit.to(device()).eval()
    feats, labels = encoder_features(vit, pool, split, batch_size, data_dir)
    return normalize_features(feats, normalize), labels


def project_2d(feats, method="tsne", seed=73):
    if method == "umap":
        try:
            import umap  # optional

            return umap.UMAP(random_state=seed).fit_transform(feats)
        except ImportError:
            from ssrl_vit_mae_jepa_torch.utils.umap_np import umap_embed

            print("umap-learn not installed: using the numpy UMAP "
                  "(ssrl_vit_mae_jepa_torch.utils.umap_np)")
            return umap_embed(feats, random_state=seed)
    try:
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise RuntimeError("t-SNE needs scikit-learn; use --method umap") from e
    perplexity = min(30.0, max(2.0, (len(feats) - 1) / 3))
    return TSNE(n_components=2, random_state=seed, init="pca",
                perplexity=perplexity).fit_transform(feats)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize encoder representations")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--pool", type=str, default="cls", choices=["cls", "mean"])
    parser.add_argument("--normalize", type=str, default="none",
                        choices=["none", "l2", "channel"])
    parser.add_argument("--method", type=str, default="umap", choices=["umap", "tsne"])
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--tag", type=str, default="representation")
    parser.add_argument("--output_dir", type=str, default="assets/visualizations")
    args = parser.parse_args(argv)
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.data.stl10 import CLASSES

    cfg = load_config(args.config)
    feats, labels = extract_features(cfg, args.checkpoint, pool=args.pool,
                                     normalize=args.normalize, split=args.split)
    print(f"Extracted features: {feats.shape}")
    xy = project_2d(feats, args.method)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable: skipping plots")
        return xy

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    base = f"{args.tag}_{args.method}_{args.pool}_{args.normalize}"
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(xy[:, 0], xy[:, 1], c=labels, cmap="tab10", s=4, alpha=0.7)
    ax.set_title(f"{args.method.upper()} of encoder features ({args.pool} pool)")
    fig.colorbar(sc, ax=ax, ticks=range(10))
    fig.savefig(out_dir / f"{base}.png", dpi=120)
    plt.close(fig)
    for c in range(10):
        fig, ax = plt.subplots(figsize=(6, 6))
        mask = labels == c
        ax.scatter(xy[~mask, 0], xy[~mask, 1], c="lightgray", s=4, alpha=0.5)
        ax.scatter(xy[mask, 0], xy[mask, 1], c="tab:red", s=6, alpha=0.8)
        ax.set_title(f"class {c}: {CLASSES[c]}")
        fig.savefig(out_dir / f"{base}_class{c}.png", dpi=120)
        plt.close(fig)
    print(f"Saved 11 plots to {out_dir}/{base}*.png")
    return xy


if __name__ == "__main__":
    main()
