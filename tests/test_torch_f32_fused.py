"""The f32 route of the whole block, the chain and the fused patch embed, as
an f32 model trains through them: one ``MAETask`` step at f32 with
``SSRL_FUSED_EMBED=force`` on ``attn_impl="block"`` and on ``"chain"``
against the JAX ``MAETask`` at f32 under the same switch, the JAX Pallas
kernels in interpret mode; and the launch counters of the f32 kernels
(``csrc/fused_block_f32.cu``, ``block_chain_f32.cu``, ``patch_embed_f32.cu``),
whose C entries must be declared to the loader. The CUDA kernels are held to
the plain versions on the card by ``tests/test_torch_cuda.py``.

The width is one the JAX embed takes (``embed_pallas.embed_supported``:
``min(Pc, D) >= 128``): 32 px images, patch 8 (N = 16, Pc = 192), encoder
D = 128, H = 4, depth 1 under "block" and 2 under "chain" (a chain needs a
stack of two), decoder 32 wide. Tolerances are those of
``tests/test_torch_block_mono.py``'s step (``assert_steps_match``): sums
rel 1e-5, Adam's first moments within 5e-6, the params within 2·lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssrl_vit_mae_jepa_torch import _build
from ssrl_vit_mae_jepa_torch.models import vit as tvit
from ssrl_vit_mae_jepa_torch.ops import block_chain as tbc
from ssrl_vit_mae_jepa_torch.ops import block_fused as bf
from ssrl_vit_mae_jepa_torch.ops import embed_fused as ef
from ssrl_vit_mae_jepa_torch.training.tasks import MAETask as TMAETask
from ssrl_vit_mae_jepa_torch.utils.interop import mae_params_from_jax, mae_params_to_state
from ssrl_vit_mae_jepa_tpu.ops.augment import draw_augment_params
from ssrl_vit_mae_jepa_tpu.ops.embed_pallas import embed_supported
from ssrl_vit_mae_jepa_tpu.ops.masking import random_token_mask
from ssrl_vit_mae_jepa_tpu.training.tasks import MAETask as JMAETask
from tests.test_torch_block_mono import _tree_np, assert_steps_match
from tests.test_torch_mae_step import PRE_CFG

STEP_B, IMG, PATCH, ENC_D = 4, 32, 8, 128
# attn_impl -> encoder and decoder depth
DEPTH = {"block": 1, "chain": 2}


def _cfg(impl):
    return {"general": {"image_size": IMG, "patch_size": PATCH, "in_chans": 3},
            "encoder": {"embed_dim": ENC_D, "depth": DEPTH[impl], "num_heads": 4},
            "decoder": {"decoder_embed_dim": 32, "decoder_depth": DEPTH[impl],
                        "decoder_num_heads": 4}}


@pytest.mark.parametrize("impl", list(DEPTH))
def test_f32_mae_step_with_fused_embed_matches_jax(monkeypatch, impl):
    """The slice as a whole: an f32 MAETask step whose encoder prologue is
    the fused patch embed and whose stacks take the whole-block or chain
    route, on both sides, from the same params and draws."""
    monkeypatch.setenv("SSRL_FUSED_EMBED", "force")
    cfg = _cfg(impl)
    jtask = JMAETask(cfg, PRE_CFG, dtype=jnp.float32, attn_impl=impl)
    jstate = jtask.init_state(jax.random.PRNGKey(0))
    ctx = jtask.epoch_context(0)
    N = (IMG // PATCH) ** 2
    images = np.random.default_rng(0).integers(0, 256, (STEP_B, IMG, IMG, 3)).astype(np.uint8)
    batch = {"image": images, "label": np.zeros(STEP_B, np.int32),
             "weight": np.array([1.0, 1.0, 0.5, 1.0], np.float32)}
    _, aug_rng, task_rng = jax.random.split(jstate.rng, 3)
    u, flip = draw_augment_params(aug_rng, STEP_B)
    idx_keep, idx_mask = random_token_mask(task_rng, STEP_B, jtask.sequence_length, ctx)
    assert embed_supported(STEP_B, N, PATCH * PATCH * 3, ENC_D, idx_keep.shape[1])
    params0 = _tree_np(jstate.params)
    with pltpu.force_tpu_interpret_mode():
        jnew, jsums = jtask.train_step(jax.tree.map(jnp.array, jstate), batch, 0, ctx)

    task = TMAETask(cfg, PRE_CFG, dtype=torch.float32, device="cpu", attn_impl=impl)
    state = task.init_state(0)
    mae_params_from_jax(params0, task.model)
    draws = [torch.from_numpy(np.array(a)) for a in (u, flip, idx_keep, idx_mask)]
    draws = tuple(draws[:2] + [d.long() for d in draws[2:]])
    tbatch = {"image": torch.from_numpy(images), "weight": torch.from_numpy(batch["weight"])}
    embeds = []
    fused = tvit.fused_patch_embed

    def counted(patches, *args):
        embeds.append((patches.dtype, tuple(patches.shape)))
        return fused(patches, *args)

    monkeypatch.setattr(tvit, "fused_patch_embed", counted)
    state, sums = task.train_step(state, tbatch, 0, ctx, draws=draws)
    # the encoder's prologue took the fused embed once, on f32 patches
    assert embeds == [(torch.float32, (STEP_B, N, PATCH * PATCH * 3))]
    assert_steps_match(jnew, jsums, state, sums, params0, mae_params_to_state,
                       ("loss_sum", "weight_sum"))


def test_f32_launch_keys_have_their_entries():
    """The counters that chip_smoke.py's phase 24 reads: each f32 kernel's
    key beside its bf16 twin's, and the C entries (with workspaces where the
    bf16 entry has one) that the wrappers call under ``ssrl_<entry>_f32``."""
    keys = [(bf.LAUNCHES, ("block_fwd", "block_fwd_nograd", "block_bwd")),
            (tbc.LAUNCHES, ("chain_fwd", "chain_fwd_nograd", "chain_bwd")),
            (ef.LAUNCHES, ("patch_embed_fwd", "patch_embed_bwd"))]
    for counters, names in keys:
        for name in names:
            assert name in counters and f"{name}_f32" in counters, name
    entries = ["fused_block_fwd", "fused_block_bwd", "block_chain_fwd", "block_chain_bwd",
               "patch_embed_fwd", "patch_embed_bwd"]
    for entry in entries:
        for suffix in ("", "_workspace"):
            bf16 = f"ssrl_{entry}{suffix}"
            if bf16 in _build._SIGNATURES:
                assert _build._SIGNATURES[f"ssrl_{entry}_f32{suffix}"] == _build._SIGNATURES[bf16]
        assert f"ssrl_{entry}_f32" in _build._SIGNATURES
    assert bf.dtype_key(torch.float32, "block_bwd") == "block_bwd_f32"
    assert bf.dtype_key(torch.bfloat16, "block_bwd") == "block_bwd"
