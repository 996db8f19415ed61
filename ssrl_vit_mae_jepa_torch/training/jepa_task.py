"""JEPA pretraining task: EMA target encoder + latent predictor.

Port of ``ssrl_vit_mae_jepa_tpu/training/jepa_task.py:32-304``. The
conventions are MAE's: AdamW at lr·batch/256, warmup×cosine per epoch, grad
clip 1.0. A step draws the augmentation (when ``augment`` is on), then the
I-JEPA masks (``ops/jepa_masking.py``) from ``state.generator``; the
predictor's latents at the target tokens are held to the EMA target
encoder's by MSE. Under ``SSRL_JEPA_DENSE_LOSS=1`` (read at construction)
both towers return every token and the error is weighted by the targets'
occupancy instead (``JEPA.predict_dense``): the same loss, gradients and
collapse metrics, overlapping target blocks counted twice as the gathered
rows count them.

The target encoder's weights live in ``state.extra`` by the encoder's own
names. They run under ``torch.no_grad()`` through
``torch.func.functional_call``, so they never reach the gradient, the
optimizer or the clip norm, and after every optimizer step they move toward
the context encoder: ``t·m + p·(1 - m)`` in f32, with the momentum ``m``
annealed per step once the trainer gives the epoch length
(``on_fit_start``) and per epoch until then, computed on the device from
the optimizer's step count. Under data parallelism the
collapse metrics' moments are summed over the ranks before the std is
taken (``_gsum`` of the JAX task), and the EMA, computed from the
all-reduced update, stays the same on every rank. Over a model axis the
EMA runs on each rank's shards, the moments are summed over the data group
only, and the drift's norms over the model group as the clip's are
(``optim.global_sq_sum``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.models.jepa import jepa_from_config
from ssrl_vit_mae_jepa_torch.ops.jepa_masking import sample_jepa_masks
from ssrl_vit_mae_jepa_torch.ops.masking import token_occupancy
from ssrl_vit_mae_jepa_torch.training.optim import global_sq_sum
from ssrl_vit_mae_jepa_torch.training.schedules import (
    effective_pretrain_lr,
    ema_momentum_at_step,
)
from ssrl_vit_mae_jepa_torch.training.state import TrainState
from ssrl_vit_mae_jepa_torch.training.tasks import Task, _weighted
from ssrl_vit_mae_jepa_torch.utils.interop import jepa_params_to_state

_ENC = "encoder."


class JEPATask(Task):
    flax_params_to_state = staticmethod(jepa_params_to_state)

    def __init__(self, model_cfg: dict, jepa_cfg: dict, dtype=torch.bfloat16,
                 device="cuda", attn_impl: str = "auto", augment: Optional[bool] = None):
        super().__init__(device)
        self.model = jepa_from_config(model_cfg, jepa_cfg, dtype=dtype, attn_impl=attn_impl)
        base = float(jepa_cfg.get("base_learning_rate", 1.5e-4))
        self.batch_size = int(jepa_cfg.get("batch_size", 512))
        self.base_lr = effective_pretrain_lr(base, self.batch_size)
        self.weight_decay = float(jepa_cfg.get("weight_decay", 0.05))
        self.warmup_epochs = int(jepa_cfg.get("warmup_epochs", 20))
        self.total_epochs = int(jepa_cfg.get("total_epochs", 200))
        self.grad_clip = 1.0
        self.augment = bool(jepa_cfg.get("augment", True)) if augment is None else augment
        self.dense_loss = os.environ.get("SSRL_JEPA_DENSE_LOSS", "0") == "1"
        self.ema_start = float(jepa_cfg.get("ema_start", 0.996))
        self.ema_end = float(jepa_cfg.get("ema_end", 1.0))
        # set by on_fit_start; until then the momentum anneals per epoch
        self.total_steps: Optional[int] = None
        self.steps_per_epoch: Optional[int] = None

        self.image_size = self.model.image_size
        self.grid_size = self.image_size // self.model.patch_size
        self.num_patches = self.model.num_patches
        self.sequence_length = self.model.sequence_length
        self.num_blocks = int(jepa_cfg.get("num_target_blocks", 4))
        scale = jepa_cfg.get("target_scale", [0.15, 0.2])
        self.block_area = max(4, round(sum(scale) / 2 * self.num_patches))
        aspect = jepa_cfg.get("target_aspect_ratio", [0.75, 1.5])
        self.aspect_range = (float(aspect[0]), float(aspect[1]))
        self.context_size = max(8, self.num_patches - self.num_blocks * self.block_area)
        self.context_sampling = str(jepa_cfg.get("context_sampling", "complement"))
        cscale = jepa_cfg.get("context_scale", [0.85, 1.0])
        self.context_scale = (float(cscale[0]), float(cscale[1]))

    def draw_task(self, generator: torch.Generator, batch: int, ctx):
        """(target patch indices (B, T), context patch indices (B, C))."""
        return sample_jepa_masks(
            generator, batch, self.grid_size, self.num_blocks, self.block_area,
            self.context_size, self.aspect_range,
            context_sampling=self.context_sampling, context_scale=self.context_scale,
        )

    def init_extra(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The EMA target encoder starts as a copy of the context encoder."""
        return {k[len(_ENC):]: v.detach().clone() for k, v in params.items()
                if k.startswith(_ENC)}

    @staticmethod
    def _ctx_tokens(ctx_patch_idx: torch.Tensor) -> torch.Tensor:
        """Patch-space context indices → token space with CLS pinned first."""
        cls = torch.zeros_like(ctx_patch_idx[:, :1])
        return torch.cat([cls, ctx_patch_idx + 1], dim=1)

    def loss_and_metric_sums(self, images, batch, task_draws, ctx, extra=None):
        t_idx, c_idx = task_draws
        idx_ctx = self._ctx_tokens(c_idx)
        idx_tgt = t_idx + 1
        w = batch["weight"]
        T = idx_tgt.shape[1]
        mask = None
        if self.dense_loss:
            pred = self.model.predict_dense(images, idx_ctx)
            with torch.no_grad():
                target = self.model.target_representations_dense(extra, images)
            predf, targf = pred.float(), target.float()
            # (B, L) counts of each token among the targets: overlapping
            # blocks count twice, exactly the gathered rows' multiset
            mask = token_occupancy(idx_tgt, self.sequence_length)
            diff = predf - targf
            per_ex = torch.sum(diff * diff * mask[:, :, None], dim=(1, 2)) / (
                T * predf.shape[-1])
        else:
            pred = self.model(images, idx_ctx, idx_tgt)
            with torch.no_grad():
                target = self.model.target_representations(extra, images, idx_tgt)
            predf, targf = pred.float(), target.float()
            per_ex = torch.mean((predf - targf) ** 2, dim=(1, 2))
        loss_sum, weight_sum = _weighted(per_ex, w)
        loss = loss_sum / self._loss_den(weight_sum)
        sums = {"loss_sum": loss_sum, "weight_sum": weight_sum}
        sums.update(self._collapse_sums(predf.detach(), targf, w, weight_sum.detach(), mask))
        return loss, sums

    @torch.no_grad()
    def _collapse_sums(self, predf, targf, w, weight_sum, mask=None):
        """Collapse diagnostics as weighted sums (``jepa_task.py:171-231``):
        the mean over dims of the weighted std of the (B·M, D) predictor
        outputs and target representations, from the moments
        ``s2/tot - mu²`` summed over every rank, and the weighted mean
        row-wise cosine. The rows weigh their example's weight; on the dense
        route all L rows, each also times its target occupancy."""
        Bc, M, D = predf.shape
        if mask is None:
            rows_w = w.float().repeat_interleave(M)
        else:
            rows_w = (mask * w.float()[:, None]).reshape(-1)

        def wstd(x):
            tot = torch.sum(rows_w)[None]
            s1 = torch.sum(x * rows_w[:, None], dim=0)
            s2 = torch.sum(x * x * rows_w[:, None], dim=0)
            if self.axis is not None:
                tot, s1, s2 = self._data_sum([tot, s1, s2])
            tot = torch.clamp_min(tot, 1e-9)
            mu = s1 / tot
            var = s2 / tot - mu * mu
            return torch.mean(torch.sqrt(torch.clamp_min(var, 0.0)))

        p2, t2 = predf.reshape(Bc * M, D), targf.reshape(Bc * M, D)
        dot = torch.sum(p2 * t2, dim=-1)
        norm = torch.linalg.vector_norm(p2, dim=-1) * torch.linalg.vector_norm(t2, dim=-1)
        cos = (torch.sum(dot / torch.clamp_min(norm, 1e-9) * rows_w)
               / torch.clamp_min(torch.sum(rows_w), 1e-9))
        return {
            "pred_std_sum": wstd(p2) * weight_sum,
            "target_std_sum": wstd(t2) * weight_sum,
            "cos_sum": cos * weight_sum,
        }

    def _pairs(self, state: TrainState):
        """(context-encoder params, EMA tensors), in the same order."""
        names = list(state.extra)
        return [state.params[_ENC + k] for k in names], [state.extra[k] for k in names]

    @torch.no_grad()
    def ema_drift(self, state: TrainState) -> torch.Tensor:
        """Relative L2 distance between the context encoder and its EMA."""
        params, ema = self._pairs(state)
        diff = torch._foreach_sub([p.float() for p in params], [t.float() for t in ema])
        if self.model_axis is None:
            diff_sq = torch.stack(torch._foreach_norm(diff)).square().sum()
            ref_sq = torch.stack(torch._foreach_norm(ema)).square().sum()
        else:
            names = list(state.extra)
            diff_sq = global_sq_sum(names, diff, self.model_axis)
            ref_sq = global_sq_sum(names, ema, self.model_axis)
        return torch.sqrt(diff_sq / torch.clamp_min(ref_sq, 1e-12))

    def loss_and_metric_sums_in_step(self, state: TrainState, images, batch, task_draws, ctx):
        loss, sums = self.loss_and_metric_sums(images, batch, task_draws, ctx,
                                               extra=state.extra)
        sums["ema_drift_sum"] = self.ema_drift(state) * sums["weight_sum"].detach()
        return loss, sums

    def on_fit_start(self, steps_per_epoch: int) -> None:
        self.steps_per_epoch = steps_per_epoch
        self.total_steps = steps_per_epoch * self.total_epochs
        self._graph = None  # the momentum's route changed: capture anew

    def _momentum(self, state: TrainState, epoch) -> torch.Tensor:
        """The EMA momentum as a 0-d f32 tensor on the device, as
        ``jepa_task.py:261-270`` computes it: per step from the optimizer's
        count (the step count on the device, which the step advances with
        ``state.step``) once ``on_fit_start`` gave the epoch length, else per
        epoch, a constant within one epoch."""
        count = state.opt_state.count
        if self.total_steps:
            return ema_momentum_at_step(count, self.total_steps, self.ema_start, self.ema_end)
        frac = np.clip(np.float32(epoch) / np.float32(max(1, self.total_epochs)),
                       np.float32(0.0), np.float32(1.0))
        m = np.float32(self.ema_start) + frac * np.float32(self.ema_end - self.ema_start)
        return torch.full((), float(m), dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def post_update(self, state: TrainState, epoch) -> TrainState:
        """EMA ← EMA·m + params·(1 - m), in place and in f32, after the
        optimizer step."""
        m = self._momentum(state, epoch)
        params, ema = self._pairs(state)
        scaled = torch._foreach_mul(params, 1.0 - m)
        torch._foreach_mul_(ema, m)
        torch._foreach_add_(ema, scaled)
        return state

    def host_epoch_metrics(self, epoch: int) -> Dict[str, float]:
        if self.total_steps and self.steps_per_epoch:
            m = float(ema_momentum_at_step(epoch * self.steps_per_epoch, self.total_steps,
                                           self.ema_start, self.ema_end))
        else:
            frac = min(epoch / max(1, self.total_epochs), 1.0)
            m = self.ema_start + frac * (self.ema_end - self.ema_start)
        return {"ema_momentum": m}

    @staticmethod
    def epoch_metrics_from_sums(sums: Dict[str, float], prefix: str) -> Dict[str, float]:
        w = max(sums.get("weight_sum", 0.0), 1e-9)
        out = {f"{prefix}_loss": sums.get("loss_sum", 0.0) / w}
        for key, name in (
            ("pred_std_sum", "pred_std"),
            ("target_std_sum", "target_std"),
            ("cos_sum", "pred_target_cos"),
            ("ema_drift_sum", "ema_drift"),
        ):
            if key in sums:
                out[f"{prefix}_{name}"] = sums[key] / w
        return out
