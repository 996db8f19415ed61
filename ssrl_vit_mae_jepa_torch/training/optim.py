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

Parameters and moments are updated in place (``torch._foreach_*``), which
the JAX package's pure updates do not need to do; it saves a copy of every
parameter per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamWState:
    learning_rate: float
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    def __init__(self, learning_rate: float, weight_decay: float,
                 grad_clip: Optional[float] = 1.0):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        zeros = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                 for p in params.values()]
        return AdamWState(self.learning_rate, 0, zeros,
                          [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]) -> None:
        """One step, in place on ``params`` and ``state``; ``grads`` has the
        same keys in the same order as ``params``."""
        p = list(params.values())
        g = [grads[k] for k in params]
        if self.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            g = torch._foreach_mul(g, factor)
        state.count += 1
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - B2)
        mu_hat = torch._foreach_div(state.mu, 1.0 - B1**state.count)
        denom = torch._foreach_sqrt(torch._foreach_div(state.nu, 1.0 - B2**state.count))
        torch._foreach_add_(denom, EPS)
        step = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(step, p, alpha=self.weight_decay)
        torch._foreach_add_(p, step, alpha=-state.learning_rate)


def make_optimizer(learning_rate: float, weight_decay: float,
                   grad_clip: Optional[float] = 1.0) -> AdamW:
    """AdamW (β 0.9/0.999, eps 1e-8) behind an optional global-norm clip."""
    return AdamW(learning_rate, weight_decay, grad_clip)


def set_learning_rate(opt_state: AdamWState, lr: float) -> AdamWState:
    opt_state.learning_rate = float(lr)
    return opt_state
