"""Train state (port of ``ssrl_vit_mae_jepa_tpu/training/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ssrl_vit_mae_jepa_torch.training.optim import AdamWState


@dataclass
class TrainState:
    #: the model's parameters by state-dict name; the step updates them in place
    params: Dict[str, torch.Tensor]
    opt_state: AdamWState
    #: on the training device; every per-step draw comes from it
    generator: torch.Generator
    step: int = 0
    #: task state that is not a parameter of the model (JEPA's EMA target
    #: encoder by the encoder's names): no gradient, no optimizer, no clip
    extra: Optional[Dict[str, torch.Tensor]] = None
