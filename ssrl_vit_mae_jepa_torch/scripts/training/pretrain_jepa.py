"""Self-supervised JEPA pretraining CLI (port of
``scripts/training/pretrain_jepa.py``).

The ``pretrain_mae`` contract: flags ``--config / --resume_from /
--output_dir_suffix`` and the layout ``<out>/pretrain/<suffix>/...``. The
loaders read the pretrain section with ``cfg["jepa"]`` merged over it
(``pretrain_jepa.py:50-52``). Two files at the end: the context encoder
under timm names as ``<out>/<logging.jepa_model_path>`` (``vit-jepa.pt``),
which ``train_mae --encoder_ckpt`` takes as it is, and ``jepa_state.ckpt``,
the parameters with the EMA target (``pretrain_jepa.py:76-90``). Data
parallel under ``torch.distributed.run`` as ``pretrain_mae``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ssrl_vit_mae_jepa_torch.parallel.multihost import is_main_process
from ssrl_vit_mae_jepa_torch.scripts.utils import (
    attn_impl,
    check_ckpt_backend,
    device,
    init_distributed,
    setup_reproducibility,
    shut_down_warnings,
)
from ssrl_vit_mae_jepa_torch.scripts.training.pretrain_mae import PERIODIC_EVERY


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Self-supervised JEPA pretraining")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--resume_from", type=str, default=None)
    parser.add_argument("--output_dir_suffix", type=str, default="jepa_pretrain")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    init_distributed()
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config, save_config_snapshot
    from ssrl_vit_mae_jepa_torch.data.loaders import get_pretrain_dataloaders
    from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask
    from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
    from ssrl_vit_mae_jepa_torch.utils.checkpoint import save_checkpoint
    from ssrl_vit_mae_jepa_torch.utils.interop import export_reference_weights
    from ssrl_vit_mae_jepa_torch.utils.load import strip_prefix

    cfg = load_config(args.config)
    jepa_cfg = cfg["jepa"]
    model_cfg = cfg["model"]
    log_cfg = cfg["logging"]
    check_ckpt_backend(log_cfg)
    dev = device()

    output_dir = Path(log_cfg["output_dir_base"]) / "pretrain" / args.output_dir_suffix
    if is_main_process():  # rank 0 writes every file
        (output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
        print(f"Saved config snapshot to: {save_config_snapshot(cfg, output_dir)}")

    # the unlabeled-split loaders, with the jepa section's batch, fraction
    # and val_split over the pretrain section's
    train_loader, val_loader = get_pretrain_dataloaders(
        {**cfg, "pretrain": {**cfg["pretrain"], **jepa_cfg}})

    trainer = Trainer(
        JEPATask(model_cfg, jepa_cfg, device=dev, attn_impl=attn_impl()),
        max_epochs=jepa_cfg["total_epochs"],
        output_dir=output_dir,
        seed=cfg.get("seed", 73),
        log_every_n_steps=log_cfg.get("log_every_n_steps"),
        periodic_ckpt_every=PERIODIC_EVERY,
        hyper_parameters={"model_cfg": model_cfg, "training_cfg": jepa_cfg},
    )
    trainer.fit(train_loader, val_loader, resume_from=args.resume_from)

    if is_main_process():
        state = trainer.task.model.state_dict()
        model_path = export_reference_weights(
            output_dir / log_cfg.get("jepa_model_path", "vit-jepa.pt"),
            strip_prefix(state, "encoder."))
        save_checkpoint(
            output_dir / "jepa_state.ckpt",
            {"state_dict": {f"model.{k}": v.detach().cpu() for k, v in state.items()},
             "extra": {k: v.detach().cpu() for k, v in trainer.state.extra.items()}},
            {"kind": "jepa_weights", "hyper_parameters": trainer.hyper_parameters,
             "weights_only": True})
        print("\nJEPA pretraining complete")
        print(f"Model weights saved to: {model_path}")
        print(f"Best checkpoint: {trainer.callbacks.best_path}")
        print(f"Logs available at: {trainer.logger.jsonl_path}")
    return trainer


if __name__ == "__main__":
    main()
