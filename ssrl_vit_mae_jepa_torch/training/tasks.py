"""Training tasks: the objective, the optimizer, the train and eval steps.

Port of ``ssrl_vit_mae_jepa_tpu/training/tasks.py``: ``Task.train_step`` is
``Task._local_train_step`` (:317-358), ``Task.eval_step`` the eval step
(:360-384), ``ClassifierTask`` (:394-477) the supervised stage with its
freeze policies, and ``MAETask`` (:480-589) the MAE objective, gathered or
dense (``SSRL_MAE_DENSE_LOSS=1``). A train step draws its randomness from
``state.generator`` (the augmentation's first when augmentation is on,
then the task's), makes the train images (:169-188: the fused
augment+patchify, the augmented images under ``SSRL_AUG_PATCHES=0``, or
``eval_transform`` with augmentation off), computes the weighted loss and
the gradients of the trainable parameters, and takes one clipped AdamW
step at the epoch's learning rate. An eval step runs under
``torch.no_grad()`` on ``eval_transform`` images (B, H, W, C) and draws the
task's masks from the generator it is given. The draws can be injected
instead, so tests can feed the JAX package's.

Data parallelism (:65-132): with a data axis (``configure_sharding``, set
by the trainer from the process grid) every rank draws at the global batch
size from the same generator and keeps its own rows, divides its loss by
the global weight sum, and all-reduces by sum over the data group its
gradients before the clip and its metric sums, so that N ranks take the
step one card takes on the whole batch.

Tensor parallelism (the JAX mesh's ``model`` axis, :86-99 there): with a
grid whose model axis is larger than 1, ``init_state`` makes the full
weights from the seed and keeps each block's shard (``models/vit.py::
shard_blocks_``), the blocks all-reduce over the model group inside
themselves, and the clip takes the full gradient's norm
(``training/optim.py``). The gradients are all-reduced over the data group
only: a replicated parameter's gradient is already the same on every model
rank, and a split one's is the rank's own. The ranks of one model row share
a data rank, so they draw the same rows from generators in lockstep.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ssrl_vit_mae_jepa_torch.models.classifier import classifier_from_config
from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config
from ssrl_vit_mae_jepa_torch.models.vit import check_tp_blocks, shard_blocks_, unshard_blocks_
from ssrl_vit_mae_jepa_torch.ops.augment import (
    apply_augment,
    apply_augment_patches,
    draw_augment_params,
    eval_transform,
)
from ssrl_vit_mae_jepa_torch.ops.masking import (
    num_masked_tokens,
    random_token_mask,
    token_occupancy,
)
from ssrl_vit_mae_jepa_torch.parallel.mesh import DataAxis, Grid, ModelAxis, all_reduce_sum
from ssrl_vit_mae_jepa_torch.training.optim import (
    make_optimizer,
    set_learning_rate,
    stop_gradients_on_frozen,
    trainable_mask,
)
from ssrl_vit_mae_jepa_torch.training.schedules import (
    effective_pretrain_lr,
    mask_ratio_at_epoch,
    warmup_cosine_factor,
)
from ssrl_vit_mae_jepa_torch.training.state import TrainState
from ssrl_vit_mae_jepa_torch.utils.interop import classifier_params_to_state, mae_params_to_state

Sums = Dict[str, torch.Tensor]


def _weighted(per_example: torch.Tensor, weight: torch.Tensor):
    return torch.sum(per_example.float() * weight), torch.sum(weight)


class Task:
    """Base: owns the model and optimizer and takes the train and eval steps.

    Subclasses set ``model``, ``base_lr``, ``weight_decay``, ``grad_clip``,
    ``warmup_epochs``, ``total_epochs`` and ``image_size`` and implement
    ``draw_task``, ``loss_and_metric_sums`` and ``epoch_metrics_from_sums``;
    the hooks ``init_extra``, ``build_mask``, ``epoch_context``,
    ``host_epoch_metrics``, ``loss_and_metric_sums_in_step``,
    ``eval_metric_sums``, ``post_update`` and ``on_fit_start`` are the JAX
    ``Task``'s (``tasks.py:134-238``). ``monitor``/``monitor_mode`` name the
    metric the trainer's best checkpoint follows; ``augment`` says whether
    the train images are augmented; ``flax_params_to_state`` maps the JAX
    task's params tree to the model's state dict (a resume from a JAX-native
    checkpoint)."""

    model: torch.nn.Module
    monitor = "val_loss"
    monitor_mode = "min"
    augment = True
    flax_params_to_state: Optional[Callable[[dict], Dict]] = None

    def __init__(self, device):
        self.device = torch.device(device)
        self.tx = None
        #: name -> trainable, from ``build_mask`` (None: every parameter)
        self.mask: Optional[Dict[str, bool]] = None
        #: the ranks the batch is split over (``configure_sharding``)
        self.axis: Optional[DataAxis] = None
        #: the ranks the blocks are split over; None without one larger than 1
        self.model_axis: Optional[ModelAxis] = None
        #: the captured step of ``train_steps_fused``
        self._graph: Optional[StepGraph] = None

    # ---- data and tensor parallelism -------------------------------------
    def configure_sharding(self, grid) -> None:
        """Run the steps over ``grid`` (``parallel.mesh.get_mesh``'s; a
        bare ``DataAxis`` or None: data parallelism or this process alone).
        A one-rank axis takes the same code path and gives the same bits. A
        model axis larger than 1 is checked against the model here (each
        block's route, heads and hidden units) and takes effect at
        ``init_state``, which must come after."""
        if grid is None or isinstance(grid, DataAxis):
            grid = Grid(grid, None)
        model = grid.model if grid.model is not None and grid.model.size > 1 else None
        if model is not None:
            if self.tx is not None:
                raise RuntimeError("configure the model axis before init_state: the "
                                   "weights are cut into shards when they are made")
            check_tp_blocks(self.model, model.size)
        self.axis = grid.data
        self.model_axis = model
        self._graph = None

    def _data_sum(self, tensors):
        """All-reduce by sum over the data group."""
        return all_reduce_sum(tensors, self.axis.group)

    def _draw_sliced(self, draw, generator: torch.Generator, local_b: int, *args) -> Tuple:
        """``draw(generator, B, *args)``, a tuple of per-example draws with a
        leading batch dim (None passes through), at this rank's rows: every
        rank draws at the global batch size and keeps its own slice, so N
        ranks consume a single card's randomness."""
        if self.axis is None:
            return tuple(draw(generator, local_b, *args))
        full = draw(generator, local_b * self.axis.size, *args)
        lo = self.axis.rank * local_b
        return tuple(None if a is None else a[lo:lo + local_b] for a in full)

    def _loss_den(self, weight_sum: torch.Tensor) -> torch.Tensor:
        """The weighted mean's denominator: the global weight sum, so that
        each rank's loss is its share of the global mean."""
        if self.axis is not None:
            (weight_sum,) = self._data_sum([weight_sum.detach().float()])
        return torch.clamp_min(weight_sum, 1.0)

    def _psum_sums(self, sums: Sums) -> Sums:
        """Metric sums over every rank."""
        if self.axis is None:
            return sums
        keys = list(sums)
        return dict(zip(keys, self._data_sum([sums[k].float() for k in keys])))

    def lr_value(self, epoch) -> float:
        return self.base_lr * warmup_cosine_factor(
            epoch, self.warmup_epochs, self.total_epochs
        )

    def epoch_context(self, epoch: int):
        """Per-epoch context of the steps (MAE's masked-token count)."""
        return None

    def host_epoch_metrics(self, epoch: int) -> Dict[str, float]:
        """Schedule values logged beside the epoch's metrics."""
        return {}

    def init_extra(self, params: Dict[str, torch.Tensor]):
        """Task state that is not a model parameter (JEPA's EMA target)."""
        return None

    def build_mask(self, params: Dict[str, torch.Tensor]) -> Optional[Dict[str, bool]]:
        """The freeze policy: name -> trainable, or None for all."""
        return None

    def draw_task(self, generator: torch.Generator, batch: int, ctx) -> Tuple:
        """The task's own draws of one step (masks), after the augmentation's."""
        return ()

    def loss_and_metric_sums_in_step(self, state: TrainState, images, batch, task_draws, ctx):
        """The step's loss entry, which may read the whole state."""
        return self.loss_and_metric_sums(images, batch, task_draws, ctx, extra=state.extra)

    def eval_metric_sums(self, images, batch, task_draws, ctx, extra=None) -> Sums:
        return self.loss_and_metric_sums(images, batch, task_draws, ctx, extra=extra)[1]

    def post_update(self, state: TrainState, epoch) -> TrainState:
        """Hook after the optimizer update, inside :meth:`update` (and so in
        the captured step): it reads the step count from the device, where
        ``state.opt_state.count`` already counts this update."""
        return state

    def on_fit_start(self, steps_per_epoch: int) -> None:
        """Hook before the first step with the epoch length, for schedules
        that need the total step count (JEPA's EMA)."""

    def init_state(self, seed: int,
                   init_params_override: Optional[Callable[[Dict], Dict]] = None) -> TrainState:
        """Seeded weights (made on the CPU, then moved), fresh optimizer
        state over the trainable parameters, the task's extra state and a
        device generator for the per-step draws. ``init_params_override``
        maps the initial state dict to the one to load (``strict=True``),
        e.g. ``utils/load.py::merge_encoder`` of a pretrained encoder. Over
        a model axis every rank makes the full weights, then keeps its
        shards, so they are the single process's."""
        gen = torch.Generator().manual_seed(seed)
        self.model.to("cpu")  # a second call finds the model on its device
        unshard_blocks_(self.model)  # and, over a model axis, cut
        self.model.init_weights(gen)
        if init_params_override is not None:
            self.model.load_state_dict(init_params_override(self.model.state_dict()),
                                       strict=True)
        self.model.to(self.device)
        shard_blocks_(self.model, self.model_axis)
        params = dict(self.model.named_parameters())
        self.mask = self.build_mask(params)
        if self.mask is not None:
            stop_gradients_on_frozen(params, self.mask)
        self.tx = make_optimizer(self.base_lr, self.weight_decay, self.grad_clip, self.mask,
                                 self.model_axis)
        step_seed = int(torch.randint(2**62, (1,), generator=gen))
        generator = torch.Generator(self.device).manual_seed(step_seed)
        return TrainState(params, self.tx.init(params), generator,
                          extra=self.init_extra(params))

    def _draw_global(self, generator: torch.Generator, batch: int, ctx) -> Tuple:
        aug = draw_augment_params(generator, batch) if self.augment else (None, None)
        return (*aug, *self.draw_task(generator, batch, ctx))

    def draw(self, generator: torch.Generator, batch: int, ctx) -> Tuple:
        """``(u, flip, *task_draws)`` for one step of ``batch`` rows on this
        rank; with augmentation off ``u`` and ``flip`` are None and nothing
        is drawn for them."""
        return self._draw_sliced(self._draw_global, generator, batch, ctx)

    def preprocess_train(self, u, flip, images_u8: torch.Tensor) -> torch.Tensor:
        """The train images: augmented patch tokens (B, N, p·p·C); with
        ``SSRL_AUG_PATCHES=0`` (read per step) augmented images (B, H, W, C),
        which the models patchify; with augmentation off ``eval_transform``."""
        if not self.augment:
            return self.preprocess_eval(images_u8)
        if os.environ.get("SSRL_AUG_PATCHES", "1") == "1":
            return apply_augment_patches(
                u, flip, images_u8, patch_size=self.model.patch_size,
                out_size=self.image_size, dtype=torch.float32,
            )
        return apply_augment(u, flip, images_u8, out_size=self.image_size,
                             dtype=torch.float32)

    def preprocess_eval(self, images_u8: torch.Tensor) -> torch.Tensor:
        return eval_transform(images_u8, out_size=self.image_size, dtype=torch.float32)

    def gradients(self, state: TrainState, batch: Dict[str, torch.Tensor], ctx=None,
                  draws: Optional[Tuple] = None):
        """One step's ``(names, grads, sums)`` without the update: the
        trainable names and their gradients, and the task's metric sums,
        both summed over the data axis."""
        images_u8 = batch["image"]
        if draws is None:
            draws = self.draw(state.generator, images_u8.shape[0], ctx)
        u, flip, *task_draws = draws
        images = self.preprocess_train(u, flip, images_u8)
        loss, sums = self.loss_and_metric_sums_in_step(state, images, batch, task_draws, ctx)
        names = self.tx.trainable(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        sums = {k: v.detach() for k, v in sums.items()}
        if self.axis is not None:
            # one all_reduce for the gradients and the sums, over the data
            # group only; the clip must see the global gradient, or the
            # ranks' norms and updates differ
            keys = list(sums)
            out = self._data_sum([*grads, *(sums[k].to(grads[0].dtype) for k in keys)])
            grads, sums = out[:len(grads)], dict(zip(keys, out[len(grads):]))
        return names, grads, sums

    def update(self, state: TrainState, batch: Dict[str, torch.Tensor], epoch, ctx=None,
               draws: Optional[Tuple] = None) -> Sums:
        """The device work of one step, in place on ``state``: the gradients,
        the AdamW update at the rate already in ``state.opt_state`` and
        ``post_update``; returns the metric sums. It reads no host number
        that changes from step to step (the optimizer's count and rate are
        device tensors, the draws come from ``state.generator``), so a CUDA
        graph of it replays step after step."""
        names, grads, sums = self.gradients(state, batch, ctx, draws)
        self.tx.update(dict(zip(names, grads)), state.opt_state, state.params)
        self.post_update(state, epoch)
        return sums

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor], epoch,
                   ctx=None, draws: Optional[Tuple] = None):
        """One step; returns ``(state, sums)`` with ``state`` updated in place
        and ``sums`` holding the task's metric sums and ``lr``."""
        lr = self.lr_value(epoch)
        set_learning_rate(state.opt_state, lr)
        sums = self.update(state, batch, epoch, ctx, draws)
        state.step += 1
        sums["lr"] = lr
        return state, sums

    def train_steps_fused(self, state: TrainState, batch: Dict[str, torch.Tensor], epoch,
                          ctx, n: int):
        """``n`` train steps on one batch, the counterpart of the JAX
        ``Task.train_steps_fused`` (``tasks.py:240-292``): the bench's
        steady-state mode. Returns ``(state, sums)`` after the n steps, the
        sums of the last; ``state.step`` advances by n.

        On the card the step is a CUDA graph (:class:`StepGraph`): the first
        call takes one eager step on a side stream (every kernel's first
        launch and set-up happen there), captures the next, and replays the
        graph for the rest; a later call with the same state, batch shapes,
        ``ctx`` and epoch replays n times. Each replay draws new masks and
        augmentation from ``state.generator`` (registered with the graph) and
        equals an eager step bit for bit where the step's ops are
        deterministic. What a step reads from the environment
        (``SSRL_AUG_PATCHES``, ``SSRL_FUSED_EMBED``; the dense-loss switches
        are read when the task is made) is frozen at capture. Anything that
        cannot be captured raises: there is no eager fallback. Under a
        process group the all-reduces are captured too, which only
        ``nccl`` allows. On the CPU (a task made with ``device="cpu"``) it is
        the loop of n ``train_step``s."""
        if n < 1:
            raise ValueError(f"n must be at least 1, got {n}")
        if self.device.type != "cuda":
            for _ in range(n):
                state, sums = self.train_step(state, batch, epoch, ctx)
            return state, sums
        if self.axis is not None and torch.distributed.get_backend() != "nccl":
            raise RuntimeError(
                f"train_steps_fused captures the step's all-reduces in a CUDA graph, which "
                f"only the nccl backend allows; this group is "
                f"{torch.distributed.get_backend()!r}")
        lr = self.lr_value(epoch)
        set_learning_rate(state.opt_state, lr)
        key = StepGraph.key_of(state, batch, epoch, ctx)
        if self._graph is None or self._graph.key != key:
            self._graph = None  # its memory pool goes before the next capture
            self._graph = StepGraph(self, state, batch, epoch, ctx, key)
            replays, sums = n - 1, self._graph.first_sums
        else:
            replays = n
            self._graph.load(batch)
        for _ in range(replays):
            self._graph.graph.replay()
        if replays:
            sums = {k: v.clone() for k, v in self._graph.sums.items()}
        state.step += n
        sums["lr"] = lr
        return state, sums

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator], ctx=None,
                  draws: Optional[Tuple] = None) -> Sums:
        """The metric sums of one eval batch under the state's weights
        (``state.extra`` for JEPA's target); the task's masks come from
        ``generator`` unless ``draws`` gives them."""
        images = self.preprocess_eval(batch["image"])
        if draws is None:
            draws = self._draw_sliced(self.draw_task, generator, images.shape[0], ctx)
        sums = self.eval_metric_sums(images, batch, tuple(draws), ctx, extra=state.extra)
        return self._psum_sums(sums)


class StepGraph:
    """One ``Task.update`` captured in a CUDA graph, with the static batch
    it reads. Made by ``Task.train_steps_fused``: one eager step on a side
    stream first (the first of the caller's steps: it warms every kernel
    route, the autograd engine and the lazy set-up a capture may not do),
    then the capture of the next, which runs nothing until a replay. The
    graph holds the addresses of the state's tensors, so ``key`` names
    them, with what else the captured work depends on."""

    def __init__(self, task: "Task", state: TrainState, batch: Dict[str, torch.Tensor],
                 epoch, ctx, key: tuple):
        self.key = key
        dev = task.device
        self.inputs = {k: v.clone() for k, v in batch.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.first_sums = task.update(state, self.inputs, epoch, ctx)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        with torch.cuda.graph(self.graph):
            self.sums = task.update(state, self.inputs, epoch, ctx)

    def load(self, batch: Dict[str, torch.Tensor]) -> None:
        """Copy ``batch`` into the static inputs the graph reads."""
        for k, v in batch.items():
            self.inputs[k].copy_(v)

    @staticmethod
    def key_of(state: TrainState, batch: Dict[str, torch.Tensor], epoch, ctx) -> tuple:
        """What a capture is valid for: the addresses of every state tensor
        the step reads or writes and which parameters train, the
        generator, the batch's shapes and types, the epoch (the JEPA
        momentum's) and ``ctx``."""
        opt = state.opt_state
        tensors = [*state.params.values(), *opt.mu, *opt.nu, opt.count, opt.learning_rate,
                   *(state.extra or {}).values()]
        return (tuple(t.data_ptr() for t in tensors),
                tuple(p.requires_grad for p in state.params.values()),
                id(state.generator),
                tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items()),
                float(epoch), ctx)


class ClassifierTask(Task):
    """Supervised CE training of ``ViTClassifier`` (reference
    ``src/training/classifier.py:16-171``): CE from an f32 log-softmax,
    accuracy and top-5 sums, AdamW over the trainable parameters at the
    configured lr with warmup×cosine and no batch scaling (quirk Q3), and
    the freeze policy as the optimizer's mask (``training/optim.py``)."""

    monitor = "val_acc"
    monitor_mode = "max"
    flax_params_to_state = staticmethod(classifier_params_to_state)

    def __init__(self, model_cfg: dict, training_cfg: dict, num_classes: int = 10,
                 dtype=torch.bfloat16, device="cuda", attn_impl: str = "auto",
                 augment: bool = True):
        super().__init__(device)
        self.model = classifier_from_config(model_cfg, num_classes=num_classes,
                                            dtype=dtype, attn_impl=attn_impl)
        self.base_lr = float(training_cfg.get("learning_rate", 3e-4))
        self.weight_decay = float(training_cfg.get("weight_decay", 0.05))
        self.warmup_epochs = int(training_cfg.get("warmup_epochs", 5))
        self.total_epochs = int(training_cfg.get("total_epochs", 100))
        self.grad_clip = 1.0
        self.augment = augment
        self.image_size = self.model.img_size
        self._freeze_encoder = bool(training_cfg.get("freeze_encoder", True))
        self._unfreeze_last = training_cfg.get("unfreeze_last_layers", None)

    def set_freeze_policy(self, freeze_encoder: bool = False,
                          unfreeze_last_layers: Optional[int] = None) -> None:
        """The reference's config-override precedence
        (``scripts/training/train_mae.py:166-176``), before ``init_state``."""
        self._freeze_encoder = freeze_encoder
        self._unfreeze_last = unfreeze_last_layers

    def build_mask(self, params):
        return trainable_mask(params, freeze_encoder=self._freeze_encoder,
                              unfreeze_last_layers=self._unfreeze_last,
                              depth=self.model.depth)

    def loss_and_metric_sums(self, images, batch, task_draws, ctx, extra=None):
        logits = self.model(images)
        labels = batch["label"].long()
        logp = F.log_softmax(logits.float(), dim=-1)
        per_ex = -logp.gather(1, labels[:, None])[:, 0]
        w = batch["weight"]
        loss_sum, weight_sum = _weighted(per_ex, w)
        correct = (torch.argmax(logits, dim=1) == labels).float()
        top = torch.topk(logits, min(5, logits.shape[-1]), dim=1).indices
        in_top5 = torch.any(top == labels[:, None], dim=1).float()
        loss = loss_sum / self._loss_den(weight_sum)
        return loss, {"loss_sum": loss_sum, "acc_sum": torch.sum(correct * w),
                      "top5_sum": torch.sum(in_top5 * w), "weight_sum": weight_sum}

    @staticmethod
    def epoch_metrics_from_sums(sums: Dict[str, float], prefix: str) -> Dict[str, float]:
        w = max(sums.get("weight_sum", 0.0), 1e-9)
        out = {f"{prefix}_loss": sums.get("loss_sum", 0.0) / w,
               f"{prefix}_acc": sums.get("acc_sum", 0.0) / w}
        if "top5_sum" in sums:
            out[f"{prefix}_top5"] = sums["top5_sum"] / w
        return out


class MAETask(Task):
    """MAE pretraining (reference ``src/training/mae.py:14-83``): per-sample
    random masking, MSE on the masked patches, AdamW at lr·batch/256 with
    warmup×cosine, and the per-epoch mask-ratio ramp. ``attn_impl`` picks the
    blocks' route as in the JAX ``MAETask``; the step runs on the card unless
    ``device`` says otherwise. ``training_cfg["augment"]`` (default on) off
    trains on ``eval_transform`` images, the reference's effective training
    (quirk Q1). ``SSRL_MAE_DENSE_LOSS=1``, read here, takes the
    dense loss: every token predicted, the squared error weighted by the
    masked tokens' occupancy (the same loss and gradients)."""

    flax_params_to_state = staticmethod(mae_params_to_state)

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
        self.augment = bool(training_cfg.get("augment", True))
        self.image_size = self.model.image_size
        self.sequence_length = self.model.sequence_length
        self.dense_loss = os.environ.get("SSRL_MAE_DENSE_LOSS", "0") == "1"

    def epoch_context(self, epoch: int) -> int:
        """The static masked-token count of this epoch."""
        ratio = mask_ratio_at_epoch(epoch, self.mask_start, self.mask_end,
                                    self.ramp_epochs)
        return num_masked_tokens(self.sequence_length, ratio)

    def host_epoch_metrics(self, epoch: int) -> Dict[str, float]:
        return {"mask_ratio": mask_ratio_at_epoch(epoch, self.mask_start, self.mask_end,
                                                  self.ramp_epochs)}

    def draw_task(self, generator: torch.Generator, batch: int, ctx):
        return random_token_mask(generator, batch, self.sequence_length, int(ctx))

    def loss_and_metric_sums(self, images, batch, task_draws, ctx, extra=None):
        idx_keep, idx_mask = task_draws
        if self.dense_loss:
            pred, target = self.model.forward_dense(images, idx_keep)
            # (B, L) counts of each token in idx_mask: a sum, as the JAX
            # one-hot sum (a repeated index counts twice); row 0 is CLS
            occ = token_occupancy(idx_mask, self.sequence_length)[:, 1:, None]
            diff = pred[:, 1:].float() - target.float()
            per_ex = torch.sum(diff * diff * occ, dim=(1, 2)) / (
                idx_mask.shape[1] * target.shape[-1])
        else:
            pred, target = self.model(images, idx_keep, idx_mask)
            per_ex = torch.mean((pred.float() - target.float()) ** 2, dim=(1, 2))
        loss_sum, weight_sum = _weighted(per_ex, batch["weight"])
        loss = loss_sum / self._loss_den(weight_sum)
        return loss, {"loss_sum": loss_sum, "weight_sum": weight_sum}

    @staticmethod
    def epoch_metrics_from_sums(sums: Dict[str, float], prefix: str) -> Dict[str, float]:
        w = max(sums.get("weight_sum", 0.0), 1e-9)
        return {f"{prefix}_loss": sums.get("loss_sum", 0.0) / w}
