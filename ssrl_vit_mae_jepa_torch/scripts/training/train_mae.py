"""Supervised training / fine-tuning CLI: probe, partial unfreeze, full
(port of ``scripts/training/train_mae.py``).

Three init branches: ``--classifier_ckpt`` continues a full classifier;
``--encoder_ckpt`` loads a pretrained encoder with prefix detection
(``model.encoder.`` / ``encoder.`` / ``module.encoder.``, or a bare timm
ViT such as the JEPA CLI's ``vit-jepa.pt``); neither is the random-init
baseline. Then the freeze policy, by the precedence ``unfreeze_last_layers >
freeze_encoder > unfreeze`` (``train_mae.py:88-98``); the best checkpoint
follows max ``val_acc``; the weights go to ``<out>/<logging.model_path>``.
Data parallel under ``torch.distributed.run`` as ``pretrain_mae``.
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


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Fine-tune or train MAE encoder on classification task")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--encoder_ckpt", type=str, default=None,
                        help="Path to pretrained MAE encoder weights (.pt or .ckpt)")
    parser.add_argument("--classifier_ckpt", type=str, default=None,
                        help="Path to full classifier checkpoint (for fine-tuning continuation)")
    parser.add_argument("--output_dir_suffix", type=str, default="mae_finetune",
                        help="Suffix for the output directory")
    return parser.parse_args(argv)


def apply_freeze_policy(task, train_cfg: dict) -> None:
    """The config's freeze policy, ``unfreeze_last_layers`` first, then
    ``freeze_encoder`` (default True), else the whole model trains."""
    if train_cfg.get("unfreeze_last_layers", None) is not None:
        n_layers = int(train_cfg["unfreeze_last_layers"])
        print(f"Unfreezing {n_layers} encoder layers...")
        task.set_freeze_policy(unfreeze_last_layers=n_layers)
    elif train_cfg.get("freeze_encoder", True):
        print("Freezing encoder weights...")
        task.set_freeze_policy(freeze_encoder=True)
    else:
        print("Unfreezing encoder weights...")
        task.set_freeze_policy(freeze_encoder=False)


def main(argv=None):
    args = parse_args(argv)
    init_distributed()
    shut_down_warnings()
    setup_reproducibility(seed=73)

    from ssrl_vit_mae_jepa_torch.config import load_config, save_config_snapshot
    from ssrl_vit_mae_jepa_torch.data.loaders import get_train_dataloaders
    from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask
    from ssrl_vit_mae_jepa_torch.training.trainer import Trainer
    from ssrl_vit_mae_jepa_torch.utils.interop import export_reference_weights
    from ssrl_vit_mae_jepa_torch.utils.load import (
        classifier_params_from_checkpoint,
        encoder_params_from_checkpoint,
        merge_encoder,
    )

    cfg = load_config(args.config)
    model_cfg = cfg["model"]
    train_cfg = cfg["train"]
    log_cfg = cfg["logging"]
    check_ckpt_backend(log_cfg)
    dev = device()
    depth = model_cfg["encoder"]["depth"]

    output_dir = Path(log_cfg["output_dir_base"]) / "train" / args.output_dir_suffix
    if is_main_process():  # rank 0 writes every file
        (output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
        print(f"Saved config snapshot to: {save_config_snapshot(cfg, output_dir)}")

    train_loader, val_loader = get_train_dataloaders(cfg)

    task = ClassifierTask(model_cfg, train_cfg, device=dev)
    params_override = None
    if args.classifier_ckpt:
        print(f"Loading full classifier checkpoint: {args.classifier_ckpt}")
        loaded, report, _ = classifier_params_from_checkpoint(args.classifier_ckpt, depth)
        if report["missing"]:
            print(f"{len(report['missing'])} missing keys")
        params_override = lambda p: loaded  # noqa: E731
    elif args.encoder_ckpt:
        print(f"Loading pretrained encoder: {args.encoder_ckpt}")
        enc, _ = encoder_params_from_checkpoint(args.encoder_ckpt, depth)
        params_override = lambda p: merge_encoder(p, enc)  # noqa: E731
    else:
        print("Baseline: random-initialized VisionTransformer (no MAE)")
    apply_freeze_policy(task, train_cfg)

    trainer = Trainer(
        task,
        max_epochs=train_cfg["total_epochs"],
        output_dir=output_dir,
        seed=cfg.get("seed", 73),
        log_every_n_steps=log_cfg.get("log_every_n_steps"),
        hyper_parameters={"model_cfg": model_cfg, "training_cfg": train_cfg},
    )
    trainer.init_state(params_override)
    trainer.fit(train_loader, val_loader)

    if is_main_process():
        model_path = export_reference_weights(output_dir / log_cfg["model_path"],
                                              trainer.task.model.state_dict())
        print("\nTraining complete")
        print(f"Model weights saved to: {model_path}")
        print(f"Best checkpoint: {trainer.callbacks.best_path}")
        print(f"Logs available at: {trainer.logger.jsonl_path}")
    return trainer


if __name__ == "__main__":
    main()
