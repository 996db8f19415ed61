"""End-to-end walkthrough on the PyTorch port: the counterpart of
``examples/walkthrough.py``. Build data, pretrain an MAE, probe it, evaluate,
and reconstruct, all at demo scale, with the same config overrides and
flags, through ``ssrl_vit_mae_jepa_torch`` only.

Run:  python examples/torch_walkthrough.py [--data_dir DIR] [--epochs N]
(Uses a synthetic STL-10 unless a real ``stl10_binary`` is present.) It runs
on the card; ``SSRL_TORCH_DEVICE=cpu`` asks for the CPU. With no card and no
such request it stops at once: it never falls back on its own.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--workdir", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=64)
    args = parser.parse_args(argv)

    from ssrl_vit_mae_jepa_torch.scripts.utils import device, setup_reproducibility

    dev = device()  # the card, or the CPU when SSRL_TORCH_DEVICE=cpu asks for it
    setup_reproducibility()

    from ssrl_vit_mae_jepa_torch.config import DEFAULTS, _deep_merge
    from ssrl_vit_mae_jepa_torch.data import loaders, stl10
    from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask, MAETask
    from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
    from ssrl_vit_mae_jepa_torch.utils.load import (
        encoder_params_from_checkpoint,
        merge_encoder,
    )

    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="ssrl_demo_"))
    data_dir = args.data_dir
    if data_dir is None:
        data_dir = workdir / "data"
        print(f"🧪 Writing synthetic STL-10 to {data_dir}")
        stl10.write_synthetic_stl10(data_dir, num_train=400, num_test=200,
                                    num_unlabeled=1000)

    cfg = _deep_merge(DEFAULTS, {})
    cfg["pretrain"].update(
        {"total_epochs": args.epochs, "warmup_epochs": 1,
         "batch_size": args.batch_size, "val_split": 0.1}
    )
    cfg["train"].update(
        {"total_epochs": args.epochs, "warmup_epochs": 1,
         "batch_size": args.batch_size, "samples_per_class": 20,
         "freeze_encoder": True, "learning_rate": 3e-4}
    )

    # 1) MAE pretraining on the unlabeled split
    print("\n=== 1. MAE pretraining ===")
    tr, va = loaders.get_pretrain_dataloaders(cfg, data_dir=data_dir)
    mae_task = MAETask(cfg["model"], cfg["pretrain"], device=dev)
    pre_trainer = Trainer(mae_task, args.epochs, workdir / "pretrain",
                          periodic_ckpt_every=25)
    pre_trainer.fit(tr, va)
    best = workdir / "pretrain/checkpoints/best.ckpt"

    # 2) frozen linear probe from the pretrained encoder
    print("\n=== 2. Frozen linear probe ===")
    tr, va = loaders.get_train_dataloaders(cfg, data_dir=data_dir)
    clf_task = ClassifierTask(cfg["model"], cfg["train"], device=dev)
    enc, _ = encoder_params_from_checkpoint(best, cfg["model"]["encoder"]["depth"])
    probe_trainer = Trainer(clf_task, args.epochs, workdir / "train")
    probe_trainer.init_state(lambda p: merge_encoder(p, enc))
    probe_trainer.fit(tr, va)

    # 3) test evaluation
    print("\n=== 3. Test evaluation ===")
    te = loaders.get_test_dataloader(cfg, data_dir=data_dir)
    metrics = probe_trainer.test(te)
    print(f"test metrics: {metrics}")

    # 4) reconstruction quality
    print("\n=== 4. Reconstruction ===")
    from ssrl_vit_mae_jepa_torch.scripts.evaluation.visualize_reconstruction import (
        reconstruct_batch,
    )

    ds = stl10.STL10(data_dir, "train")
    out = reconstruct_batch(cfg, best, ds.images_nhwc(np.arange(4)))
    print(f"masked-patch PSNR: {out['psnr']:.2f} dB (MSE {out['mse']:.4f})")
    print(f"\n✅ Walkthrough artifacts in {workdir}")


if __name__ == "__main__":
    main()
