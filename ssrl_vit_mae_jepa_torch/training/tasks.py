"""Training tasks: the objective, the optimizer and the train step.

Port of ``ssrl_vit_mae_jepa_tpu/training/tasks.py``: ``Task.train_step`` is
``Task._local_train_step`` (:317-358) on one device, and ``MAETask``
(:480-589) is the gathered-loss MAE objective. A step draws its randomness
from ``state.generator`` (augmentation first, then the token mask), applies
the fused augment+patchify, computes the weighted loss and its gradients,
and takes one clipped AdamW step at the epoch's learning rate. The draws can
be injected instead, so tests can feed the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config
from ssrl_vit_mae_jepa_torch.ops.augment import apply_augment_patches, draw_augment_params
from ssrl_vit_mae_jepa_torch.ops.masking import num_masked_tokens, random_token_mask
from ssrl_vit_mae_jepa_torch.training.optim import make_optimizer, set_learning_rate
from ssrl_vit_mae_jepa_torch.training.schedules import (
    effective_pretrain_lr,
    mask_ratio_at_epoch,
    warmup_cosine_factor,
)
from ssrl_vit_mae_jepa_torch.training.state import TrainState


def _weighted(per_example: torch.Tensor, weight: torch.Tensor):
    return torch.sum(per_example.float() * weight), torch.sum(weight)


class Task:
    """Base: owns the model and optimizer and takes the train step.

    Subclasses set ``model``, ``base_lr``, ``weight_decay``, ``grad_clip``,
    ``warmup_epochs``, ``total_epochs`` and ``image_size`` and implement
    ``draw_task`` and ``loss_and_metric_sums``; the hooks ``init_extra``,
    ``loss_and_metric_sums_in_step``, ``post_update`` and ``on_fit_start``
    are the JAX ``Task``'s (``tasks.py:143-214``)."""

    model: torch.nn.Module

    def __init__(self, device):
        self.device = torch.device(device)
        self.tx = None

    def lr_value(self, epoch) -> float:
        return self.base_lr * warmup_cosine_factor(
            epoch, self.warmup_epochs, self.total_epochs
        )

    def init_extra(self, params: Dict[str, torch.Tensor]):
        """Task state that is not a model parameter (JEPA's EMA target)."""
        return None

    def loss_and_metric_sums_in_step(self, state: TrainState, images, batch, task_draws, ctx):
        """The step's loss entry, which may read the whole state."""
        return self.loss_and_metric_sums(images, batch, task_draws, ctx)

    def post_update(self, state: TrainState, epoch) -> TrainState:
        """Hook after the optimizer update; ``state.step`` already counts it."""
        return state

    def on_fit_start(self, steps_per_epoch: int) -> None:
        """Hook before the first step with the epoch length, for schedules
        that need the total step count (JEPA's EMA)."""

    def init_state(self, seed: int) -> TrainState:
        """Seeded weights (made on the CPU, then moved), fresh optimizer
        state, the task's extra state and a device generator for the
        per-step draws."""
        gen = torch.Generator().manual_seed(seed)
        self.model.init_weights(gen)
        self.model.to(self.device)
        params = dict(self.model.named_parameters())
        self.tx = make_optimizer(self.base_lr, self.weight_decay, self.grad_clip)
        step_seed = int(torch.randint(2**62, (1,), generator=gen))
        generator = torch.Generator(self.device).manual_seed(step_seed)
        return TrainState(params, self.tx.init(params), generator,
                          extra=self.init_extra(params))

    def draw(self, generator: torch.Generator, batch: int, ctx) -> Tuple:
        """``(u, flip, *task_draws)`` for one step."""
        u, flip = draw_augment_params(generator, batch)
        return (u, flip, *self.draw_task(generator, batch, ctx))

    def preprocess_train(self, u, flip, images_u8: torch.Tensor) -> torch.Tensor:
        return apply_augment_patches(
            u, flip, images_u8, patch_size=self.model.patch_size,
            out_size=self.image_size, dtype=torch.float32,
        )

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor], epoch,
                   ctx=None, draws: Optional[Tuple] = None):
        """One step; returns ``(state, sums)`` with ``state`` updated in place
        and ``sums`` holding the task's metric sums and ``lr``."""
        images_u8 = batch["image"]
        if draws is None:
            draws = self.draw(state.generator, images_u8.shape[0], ctx)
        u, flip, *task_draws = draws
        images = self.preprocess_train(u, flip, images_u8)
        loss, sums = self.loss_and_metric_sums_in_step(state, images, batch, task_draws, ctx)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        lr = self.lr_value(epoch)
        set_learning_rate(state.opt_state, lr)
        self.tx.update(dict(zip(names, grads)), state.opt_state, state.params)
        state.step += 1
        state = self.post_update(state, epoch)
        sums = {k: v.detach() for k, v in sums.items()}
        sums["lr"] = lr
        return state, sums


class MAETask(Task):
    """MAE pretraining (reference ``src/training/mae.py:14-83``): per-sample
    random masking, MSE on the masked patches, AdamW at lr·batch/256 with
    warmup×cosine, and the per-epoch mask-ratio ramp. ``attn_impl`` picks the
    blocks' route as in the JAX ``MAETask``; the step runs on the card unless
    ``device`` says otherwise."""

    def __init__(self, model_cfg: dict, training_cfg: dict, dtype=torch.bfloat16,
                 device="cuda", attn_impl: str = "auto"):
        super().__init__(device)
        self.model = mae_from_config(model_cfg, dtype=dtype, attn_impl=attn_impl)
        self.mask_start = float(training_cfg.get("mask_ratio_start", 0.5))
        self.mask_end = float(training_cfg.get("mask_ratio_end", 0.85))
        self.ramp_epochs = int(training_cfg.get("mask_ramp_epochs", 200))
        base = float(training_cfg.get("base_learning_rate", 1.5e-4))
        self.batch_size = int(training_cfg.get("batch_size", 512))
        self.base_lr = effective_pretrain_lr(base, self.batch_size)
        self.weight_decay = float(training_cfg.get("weight_decay", 0.05))
        self.warmup_epochs = int(training_cfg.get("warmup_epochs", 20))
        self.total_epochs = int(training_cfg.get("total_epochs", 200))
        self.grad_clip = 1.0
        if not training_cfg.get("augment", True):
            raise NotImplementedError("the un-augmented MAE path is not ported yet")
        self.image_size = self.model.image_size
        self.sequence_length = self.model.sequence_length

    def epoch_context(self, epoch: int) -> int:
        """The static masked-token count of this epoch."""
        ratio = mask_ratio_at_epoch(epoch, self.mask_start, self.mask_end,
                                    self.ramp_epochs)
        return num_masked_tokens(self.sequence_length, ratio)

    def draw_task(self, generator: torch.Generator, batch: int, ctx):
        return random_token_mask(generator, batch, self.sequence_length, int(ctx))

    def loss_and_metric_sums(self, images, batch, task_draws, ctx):
        idx_keep, idx_mask = task_draws
        pred, target = self.model(images, idx_keep, idx_mask)
        per_ex = torch.mean((pred.float() - target.float()) ** 2, dim=(1, 2))
        loss_sum, weight_sum = _weighted(per_ex, batch["weight"])
        loss = loss_sum / torch.clamp_min(weight_sum, 1.0)
        return loss, {"loss_sum": loss_sum, "weight_sum": weight_sum}
