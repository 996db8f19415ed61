"""Train state (port of ``ssrl_vit_mae_jepa_tpu/training/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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
