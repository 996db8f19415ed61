"""Self-supervised MAE pretraining CLI (port of
``scripts/training/pretrain_mae.py``).

Flags ``--config / --resume_from / --output_dir_suffix``; output layout
``<logging.output_dir_base>/pretrain/<suffix>/{checkpoints,metrics.jsonl,
config.yaml}``; best-by-val_loss and last checkpoints every epoch,
weights-only ``epoch-NNN.ckpt`` every 25 epochs; the weights as the
reference's ``torch.save`` state dict at ``<out>/<logging.model_path>``.
Runs on ``scripts/utils.py::device()``; under ``python -m
torch.distributed.run --nproc_per_node N`` it trains data-parallel on N
cards (``init_distributed``), and rank 0 writes every file.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ssrl_vit_mae_jepa_torch.parallel.multihost import is_main_process
from ssrl_vit_mae_jepa_torch.scripts.utils import (
    check_ckpt_backend,
    device,
    init_distributed,
    setup_reproducibility,
    shut_down_warnings,
)

PERIODIC_EVERY = 25


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Self-supervised MAE pretraining")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="Path to checkpoint to resume from")
    parser.add_argument("--output_dir_suffix", type=str, default="mae_pretrain",
                        help="Suffix for the output directory")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    init_distributed()
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config, save_config_snapshot
    from ssrl_vit_mae_jepa_torch.data.loaders import get_pretrain_dataloaders
    from ssrl_vit_mae_jepa_torch.training.tasks import MAETask
    from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
    from ssrl_vit_mae_jepa_torch.utils.interop import export_reference_weights

    cfg = load_config(args.config)
    pre_cfg = cfg["pretrain"]
    model_cfg = cfg["model"]
    log_cfg = cfg["logging"]
    check_ckpt_backend(log_cfg)
    dev = device()

    output_dir = Path(log_cfg["output_dir_base"]) / "pretrain" / args.output_dir_suffix
    if is_main_process():  # rank 0 writes every file
        (output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
        print(f"Saved config snapshot to: {save_config_snapshot(cfg, output_dir)}")

    train_loader, val_loader = get_pretrain_dataloaders(cfg)
    trainer = Trainer(
        MAETask(model_cfg, pre_cfg, device=dev),
        max_epochs=pre_cfg["total_epochs"],
        output_dir=output_dir,
        seed=cfg.get("seed", 73),
        log_every_n_steps=log_cfg.get("log_every_n_steps"),
        periodic_ckpt_every=PERIODIC_EVERY,
        hyper_parameters={"model_cfg": model_cfg, "training_cfg": pre_cfg},
    )
    trainer.fit(train_loader, val_loader, resume_from=args.resume_from)

    if is_main_process():
        model_path = export_reference_weights(output_dir / log_cfg["model_path"],
                                              trainer.task.model.state_dict())
        print("\nPretraining complete")
        print(f"Model weights saved to: {model_path}")
        print(f"Best checkpoint: {trainer.callbacks.best_path}")
        print(f"Logs available at: {trainer.logger.jsonl_path}")
    return trainer


if __name__ == "__main__":
    main()
