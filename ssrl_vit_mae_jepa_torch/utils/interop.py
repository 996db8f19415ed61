"""Weights from the JAX package into the port.

The JAX package's ``utils/torch_interop.py`` already writes its params in
the reference's torch names and layouts; the port's modules use those names,
so crossing over is one export and one strict ``load_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

from ssrl_vit_mae_jepa_tpu.utils.torch_interop import mae_params_to_state


def mae_params_from_jax(params: dict, model: torch.nn.Module) -> torch.nn.Module:
    """Load MaskedAutoencoder params (a tree of numpy arrays) into the port's
    ``MaskedAutoencoder`` with ``strict=True``; returns ``model``."""
    state = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in mae_params_to_state(params).items()
    }
    model.load_state_dict(state, strict=True)
    return model
