"""MAE reconstruction visualizer (port of
``scripts/evaluation/visualize_reconstruction.py``).

Loads an MAE checkpoint, masks a batch of labeled training images with a
fixed-seed random mask (seed 42), runs the MAE at f32 under
``torch.no_grad()`` (the f32 branch kernels on the card) and saves a 3-row
figure: original / masked with gray fill / reconstruction with the kept
patches from the input and the masked ones from the decoder; prints MSE,
MAE and PSNR over the masked patches. ``reconstruct_batch`` also takes the
masks, so a caller can hand it another package's draws.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.scripts.utils import (
    device,
    setup_reproducibility,
    shut_down_warnings,
)

MASK_SEED = 42


@torch.no_grad()
def reconstruct_batch(cfg, checkpoint, images_u8, mask_ratio=0.75,
                      masks: Optional[Tuple] = None):
    """→ dict with the original / masked / reconstructed images in [0, 1]
    (B, H, W, C) and the masked patches' mse / mae / psnr. ``masks``:
    ``(idx_keep, idx_mask)``, else drawn from a generator seeded MASK_SEED."""
    from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config
    from ssrl_vit_mae_jepa_torch.ops.augment import eval_transform
    from ssrl_vit_mae_jepa_torch.ops.masking import (
        get_at_index,
        num_masked_tokens,
        random_token_mask,
        set_at_index,
    )
    from ssrl_vit_mae_jepa_torch.ops.patches import patchify, unpatchify
    from ssrl_vit_mae_jepa_torch.utils.load import mae_params_from_checkpoint

    dev = torch.device(device())
    model_cfg = cfg["model"]
    mae = mae_from_config(model_cfg, dtype=torch.float32)
    params, report = mae_params_from_checkpoint(
        checkpoint, model_cfg["encoder"]["depth"], model_cfg["decoder"]["decoder_depth"])
    if report["missing"]:
        print(f"Missing keys: {report['missing'][:5]} ...")
    mae.load_state_dict(params, strict=True)
    mae.to(dev).eval()

    images = eval_transform(torch.as_tensor(np.asarray(images_u8)).to(dev))  # [-1, 1]
    B, L = images.shape[0], mae.sequence_length
    p = mae.patch_size
    if masks is None:
        masks = random_token_mask(torch.Generator(dev).manual_seed(MASK_SEED), B, L,
                                  num_masked_tokens(L, mask_ratio))
    # drawn masks are tensors on ``dev``; a caller's may be numpy or JAX arrays
    idx_keep, idx_mask = ((m if isinstance(m, torch.Tensor) else torch.as_tensor(np.asarray(m)))
                          .long().to(dev) for m in masks)
    pred, target = mae(images, idx_keep, idx_mask)

    patches = patchify(images, p)  # (B, N, p·p·3)
    at = (idx_mask - 1).clamp_min(0)
    # gray (0.5 in [0, 1] = 0 in [-1, 1]) at the masked patches; the
    # reconstruction takes the prediction there
    masked_patches = set_at_index(patches, at, get_at_index(torch.zeros_like(patches), at))
    recon_patches = set_at_index(patches, at, pred.to(patches.dtype))

    def to01(x):
        return np.clip((x.float().cpu().numpy() + 1.0) / 2.0, 0, 1)

    pred_f, tgt_f = pred.float().cpu().numpy(), target.float().cpu().numpy()
    mse = float(np.mean((pred_f - tgt_f) ** 2))
    mae_err = float(np.mean(np.abs(pred_f - tgt_f)))
    psnr = 10.0 * np.log10(4.0 / max(mse, 1e-12))  # data range 2 in [-1, 1]
    return {
        "original": to01(images),
        "masked": to01(unpatchify(masked_patches, p)),
        "reconstructed": to01(unpatchify(recon_patches, p)),
        "mse": mse,
        "mae": mae_err,
        "psnr": psnr,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize MAE reconstructions")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--num_images", type=int, default=8)
    parser.add_argument("--mask_ratio", type=float, default=0.75)
    parser.add_argument("--output", type=str,
                        default="assets/visualizations/reconstruction_validation.png")
    args = parser.parse_args(argv)
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.data.loaders import default_data_dir
    from ssrl_vit_mae_jepa_torch.data.stl10 import STL10

    cfg = load_config(args.config)
    ds = STL10(default_data_dir(), "train")
    images_u8 = ds.images_nhwc(np.arange(args.num_images))
    out = reconstruct_batch(cfg, args.checkpoint, images_u8, args.mask_ratio)
    print(f"Masked-patch metrics: MSE={out['mse']:.4f} MAE={out['mae']:.4f} "
          f"PSNR={out['psnr']:.2f} dB")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable: skipping figure")
        return out

    n = args.num_images
    fig, axes = plt.subplots(3, n, figsize=(2 * n, 6))
    rows = [("Original", out["original"]), ("Masked", out["masked"]),
            ("Reconstructed", out["reconstructed"])]
    for r, (title, imgs) in enumerate(rows):
        for c in range(n):
            ax = axes[r, c] if n > 1 else axes[r]
            ax.imshow(imgs[c])
            ax.axis("off")
        (axes[r, 0] if n > 1 else axes[r]).set_title(title, loc="left")
    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"Saved figure to {out_path}")
    return out


if __name__ == "__main__":
    main()
