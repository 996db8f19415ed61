"""The port's from-scratch initialisation against the JAX package's, on the
CPU: for MAE, JEPA and the classifier, every parameter tensor of the port's
``init_weights`` (through ``Task.init_state``) against the same tensor of
the JAX ``init_params``, mapped by the port's own converters
(``utils/interop.py``).

The two draw from different generators, so their statistics are compared
within sampling tolerance, not their values. For a tensor of n draws with
std s, each side's mean has a standard error of s/√n and its std a relative
one of at most 1/√(2n); the difference of the two sides is held to five of
its standard errors: |Δmean| ≤ 5·√2·s/√n and |Δstd| / s ≤ 5/√n. The
truncation is held through max|x|/std: both initializers cut a normal at
±2 of its pre-cut std, so the ratio is at most 2/0.8796 = 2.274 whatever
the std, up to the sample std's own error. Tensors that the JAX package
sets to a constant (biases, LayerNorm scales, the encoder's unused mask
token) must be that constant in the port.

Geometry: the toy MAE (96 px, patch 8, encoder 48/2/4, decoder 32/1/4) of
``tests/test_torch_mae_step.py``, the toy JEPA (predictor 32/1/4) of
``tests/test_torch_jepa.py`` and the toy classifier (the same encoder, 10
classes) of ``tests/test_torch_classifier.py``; f32. The classifier's
head is 480 draws, so its bounds are the widest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrl_vit_mae_jepa_torch.training.jepa_task import JEPATask as TJEPATask
from ssrl_vit_mae_jepa_torch.training.tasks import ClassifierTask as TClassifierTask
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_tpu.training.jepa_task import JEPATask as JJEPATask
from ssrl_vit_mae_jepa_tpu.training.tasks import ClassifierTask as JClassifierTask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask

GENERAL = {"image_size": 96, "patch_size": 8, "in_chans": 3}
ENCODER = {"embed_dim": 48, "depth": 2, "num_heads": 4}
MAE_MODEL = {"general": GENERAL, "encoder": ENCODER,
             "decoder": {"decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 4}}
MAE_CFG = {"mask_ratio_start": 0.75, "mask_ratio_end": 0.75, "mask_ramp_epochs": 5,
           "total_epochs": 800, "warmup_epochs": 1, "batch_size": 4,
           "base_learning_rate": 1e-2, "weight_decay": 0.05}
JEPA_MODEL = {"general": GENERAL, "encoder": ENCODER}
JEPA_CFG = {"total_epochs": 4, "warmup_epochs": 1, "batch_size": 4,
            "base_learning_rate": 1e-2, "weight_decay": 0.05,
            "predictor_embed_dim": 32, "predictor_depth": 1, "predictor_num_heads": 4,
            "num_target_blocks": 4, "target_scale": [0.15, 0.2],
            "target_aspect_ratio": [0.75, 1.5], "ema_start": 0.99, "ema_end": 1.0}
CLS_MODEL = {"general": GENERAL, "encoder": ENCODER, "head": {"pool": "cls"}}
CLS_CFG = {"learning_rate": 1e-2, "weight_decay": 0.05, "warmup_epochs": 1,
           "total_epochs": 10, "batch_size": 4, "freeze_encoder": False}
TASKS = ("mae", "jepa", "classifier")
# the largest max|x|/std of a normal cut at +-2 of its pre-cut std
MAX_RATIO = 2.0 / 0.87962566103423978
SIGMAS = 5.0


def _port_task(task: str):
    if task == "mae":
        return TMAETask(MAE_MODEL, MAE_CFG, dtype=torch.float32, device="cpu")
    if task == "classifier":
        return TClassifierTask(CLS_MODEL, CLS_CFG, dtype=torch.float32, device="cpu")
    return TJEPATask(JEPA_MODEL, JEPA_CFG, dtype=torch.float32, device="cpu")


@functools.lru_cache(maxsize=None)
def _states(task: str):
    """(JAX init as a torch-named state dict, the port's), numpy f32."""
    if task == "mae":
        jtask = JMAETask(MAE_MODEL, MAE_CFG, dtype=jnp.float32)
        to_state = interop.mae_params_to_state
    elif task == "classifier":
        jtask = JClassifierTask(CLS_MODEL, CLS_CFG, dtype=jnp.float32)
        to_state = interop.classifier_params_to_state
    else:
        jtask = JJEPATask(JEPA_MODEL, JEPA_CFG, dtype=jnp.float32)
        to_state = interop.jepa_params_to_state
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jtask.init_params(jax.random.PRNGKey(0)))
    t = _port_task(task)
    t.init_state(0)
    port = {k: v.detach().float().numpy() for k, v in t.model.state_dict().items()}
    return to_state(params), port


def _names(task: str):
    """The port's parameter names, from the model alone (no draw)."""
    return sorted(_port_task(task).model.state_dict())


CASES = [(task, name) for task in TASKS for name in _names(task)]


def test_every_fixed_tensor_is_covered():
    """The two init repairs are among the cases."""
    assert ("jepa", "predictor_proj.weight") in CASES
    assert ("mae", "encoder.vit.patch_embed.proj.weight") in CASES
    assert ("jepa", "encoder.patch_embed.proj.weight") in CASES
    assert ("classifier", "head.classification.weight") in CASES
    assert ("classifier", "encoder.patch_embed.proj.weight") in CASES


def test_the_converters_name_every_port_tensor():
    for task in TASKS:
        jax_state, port = _states(task)
        assert set(jax_state) == set(port), task


@pytest.mark.parametrize("task,name", CASES)
def test_init_statistics_match_the_jax_package(task, name):
    jax_state, port = _states(task)
    a, b = jax_state[name].astype(np.float64), port[name].astype(np.float64)
    assert a.shape == b.shape
    sa = a.std()
    if sa == 0.0:  # a constant in the JAX package: the same constant here
        np.testing.assert_array_equal(b, a)
        return
    n = a.size
    sb = b.std()
    assert abs(b.mean() - a.mean()) <= SIGMAS * np.sqrt(2.0) * sa / np.sqrt(n), (
        f"mean {b.mean():.5f} against {a.mean():.5f}")
    assert abs(sb - sa) / sa <= SIGMAS / np.sqrt(n), f"std {sb:.5f} against {sa:.5f}"
    # the sample std itself is off by up to SIGMAS / sqrt(2n) of it
    cap = MAX_RATIO * (1.0 + SIGMAS / np.sqrt(2.0 * n))
    ra, rb = np.abs(a).max() / sa, np.abs(b).max() / sb
    assert ra <= cap and rb <= cap, (ra, rb, cap)
