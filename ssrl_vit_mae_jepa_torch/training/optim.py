"""AdamW with global-norm clipping, to optax's semantics.

Port of ``ssrl_vit_mae_jepa_tpu/training/optim.py:29-62``, i.e.
``inject_hyperparams(chain(clip_by_global_norm(c), adamw(lr, 0.9, 0.999,
1e-8, wd)))``:

- clip: with n = sqrt(sum of squares of every gradient), gradients are
  scaled by c/n when n >= c and left as they are otherwise (no epsilon on
  n, unlike ``torch.nn.utils.clip_grad_norm_``);
- Adam on bias-corrected moments, eps outside the square root;
- decoupled weight decay ``wd * param`` on every parameter, added to the
  Adam direction before the learning rate scales it;
- the learning rate is state, set per epoch (``set_learning_rate``).

The step ``count`` (int32) and the ``learning_rate`` (f32) are 0-d tensors
on the parameters' device, as optax keeps them: the step advances
``count`` on the device and takes the bias corrections ``1 - β**count`` in
f32 from it, and ``set_learning_rate`` fills the tensor in place. So the
step reads no host number that changes from one step to the next, and a
CUDA graph of it (``Task.train_steps_fused``) replays each step's own
bias correction and the rate set before the replay.

The freeze policy (``optim.py:64-120`` of the JAX package) is
``optax.masked`` over that chain with ``stop_gradient`` on frozen leaves.
Here a frozen parameter gets ``requires_grad_(False)`` (so autograd never
computes its gradient and the branch kernels take their no-grad forwards
where nothing upstream needs one), and the optimizer's ``trainable_mask``
leaves it out of the clip norm, the Adam state and the weight decay: it
comes out of a step bit-identical.

Parameters and moments are updated in place (``torch._foreach_*``), which
the JAX package's pure updates do not need to do; it saves a copy of every
parameter per step.

Over a model axis (``model_axis``, set by the task) a rank holds shards of
the split tensors (``parallel/mesh.py``), so the clip's norm is
``global_sq_sum``'s: the squared norms of the split gradients summed over
the model group, the replicated ones (equal on every model rank) counted
once. AdamW and the weight decay are elementwise and run on the shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ssrl_vit_mae_jepa_torch.parallel.mesh import ModelAxis, all_reduce_sum, param_shardings

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamWState:
    #: 0-d f32 on the parameters' device
    learning_rate: torch.Tensor
    #: 0-d int32 on the parameters' device: the updates taken
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def global_sq_sum(names: Sequence[str], tensors: Sequence[torch.Tensor],
                  model_axis: ModelAxis) -> torch.Tensor:
    """The sum of squares of the full tensors of which this rank holds
    ``tensors`` (by ``names``) over ``model_axis``: the split tensors'
    squared norms summed over the model group, the replicated ones counted
    once. It reads no host number, so a CUDA graph captures it."""
    norms = torch._foreach_norm(list(tensors))
    zero = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    split = [spec is not None for spec in param_shardings(names, model_axis.size).values()]
    rep = sum((n.float().square() for n, s in zip(norms, split) if not s), zero)
    shd = sum((n.float().square() for n, s in zip(norms, split) if s), zero)
    (shd,) = all_reduce_sum([shd.reshape(1)], model_axis.group)
    return rep + shd[0]


class AdamW:
    def __init__(self, learning_rate: float, weight_decay: float,
                 grad_clip: Optional[float] = 1.0,
                 trainable_mask: Optional[Dict[str, bool]] = None,
                 model_axis: Optional[ModelAxis] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.trainable_mask = trainable_mask
        #: the model axis the split parameters are sharded over (None: none)
        self.model_axis = model_axis

    def trainable(self, params: Dict[str, torch.Tensor]) -> List[str]:
        """The names the optimizer updates, in ``params``' order."""
        m = self.trainable_mask
        return [k for k in params if m is None or m[k]]

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        """Zero moments for the trainable parameters only."""
        zeros = [torch.zeros_like(params[k], memory_format=torch.contiguous_format)
                 for k in self.trainable(params)]
        dev = next(iter(params.values())).device
        return AdamWState(torch.tensor(self.learning_rate, dtype=torch.float32, device=dev),
                          torch.zeros((), dtype=torch.int32, device=dev), zeros,
                          [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]) -> None:
        """One step, in place on the trainable ``params`` and ``state``;
        ``grads`` holds a gradient for each trainable name and may hold
        nothing for a frozen one."""
        names = self.trainable(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.grad_clip is not None:
            if self.model_axis is None:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            else:  # the full gradient's norm, from this rank's shards
                norm = torch.sqrt(global_sq_sum(names, g, self.model_axis))
            factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            g = torch._foreach_mul(g, factor)
        state.count.add_(1)
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - B2)
        count = state.count.float()
        mu_hat = torch._foreach_div(state.mu, 1.0 - torch.pow(B1, count))
        denom = torch._foreach_sqrt(torch._foreach_div(state.nu, 1.0 - torch.pow(B2, count)))
        torch._foreach_add_(denom, EPS)
        step = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(step, p, alpha=self.weight_decay)
        # optax's scale_by_learning_rate then apply_updates: p + (-lr · u)
        torch._foreach_mul_(step, -state.learning_rate)
        torch._foreach_add_(p, step)


def make_optimizer(learning_rate: float, weight_decay: float,
                   grad_clip: Optional[float] = 1.0,
                   trainable_mask: Optional[Dict[str, bool]] = None,
                   model_axis: Optional[ModelAxis] = None) -> AdamW:
    """AdamW (β 0.9/0.999, eps 1e-8) behind an optional global-norm clip,
    over the parameters ``trainable_mask`` marks True (all without it),
    clipping by the full gradient's norm over ``model_axis``."""
    return AdamW(learning_rate, weight_decay, grad_clip, trainable_mask, model_axis)


def set_learning_rate(opt_state: AdamWState, lr: float) -> AdamWState:
    """The rate of the next updates, written into the state's tensor."""
    opt_state.learning_rate.fill_(float(lr))
    return opt_state


def _block_index(name: str) -> Optional[int]:
    """i of an ``encoder.blocks.{i}.`` parameter, else None."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "encoder" and parts[1] == "blocks":
        return int(parts[2])
    return None


def trainable_mask(params: Dict[str, torch.Tensor], freeze_encoder: bool = False,
                   unfreeze_last_layers: Optional[int] = None,
                   depth: Optional[int] = None) -> Dict[str, bool]:
    """name → True where trainable, with the reference's precedence
    (``scripts/training/train_mae.py:166-176``): ``unfreeze_last_layers`` >
    ``freeze_encoder`` > all trainable. Unfreezing n trains the last n
    encoder blocks, the final ``encoder.norm`` (not the block norms) and the
    head; n outside [0, depth] raises. ``freeze_encoder`` trains what has
    "head" in its name."""

    def decide(name: str) -> bool:
        if unfreeze_last_layers is not None:
            if depth is None:
                raise ValueError("depth required for unfreeze_last_layers")
            n = int(unfreeze_last_layers)
            if n < 0 or n > depth:
                raise ValueError(f"n_layers must be between 0 and {depth}, got {n}")
            if "head" in name:
                return True
            i = _block_index(name)
            if i is not None and depth - n <= i < depth:
                return True
            return name.startswith("encoder.norm.")
        if freeze_encoder:
            return "head" in name
        return True

    return {k: decide(k) for k in params}


def stop_gradients_on_frozen(params: Dict[str, torch.Tensor],
                             mask: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """``requires_grad`` from the mask, in place: autograd then computes no
    gradient of a frozen parameter (the JAX package's ``stop_gradient``)."""
    for k, p in params.items():
        p.requires_grad_(bool(mask[k]))
    return params


def count_trainable(params: Dict[str, torch.Tensor], mask: Dict[str, bool]) -> int:
    return int(sum(p.numel() for k, p in params.items() if mask[k]))
