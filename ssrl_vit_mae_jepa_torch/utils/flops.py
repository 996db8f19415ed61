"""Analytic FLOPs and MFU accounting for the bench.

Port of ``ssrl_vit_mae_jepa_tpu/utils/flops.py:45-119``: the *useful*
dense-matmul FLOPs of one training step from the task's static shapes, the
standard MFU numerator (PaLM appendix B: unpadded model FLOPs, backward =
2x forward). LayerNorm, softmax and elementwise work, the augmentation's
resample and the gathers are left out, so the MFU is slightly
conservative. The task is recognised by its class name, as in the JAX
package, and the widths are read from the port's modules.

``peak_flops_per_chip`` knows one card, NVIDIA's H100 SXM (dense bf16,
989 TFLOP/s, NVIDIA's H100 data sheet); ``SSRL_PEAK_TFLOPS`` overrides it
and names any other device. An unknown device gives None, and then no MFU.
"""

from __future__ import annotations

import os
from typing import Optional

# dense bf16 peak per card, FLOP/s (NVIDIA's data sheet, SXM part)
_PEAK_BY_NAME = (("H100 80GB HBM3", 989e12),)


def peak_flops_per_chip(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in FLOP/s: ``SSRL_PEAK_TFLOPS`` (TFLOP/s)
    when set, else the table's entry whose key is in ``device_name``."""
    env = os.environ.get("SSRL_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    for key, peak in _PEAK_BY_NAME:
        if key.lower() in device_name.lower():
            return peak
    return None


def block_flops(L: int, D: int, mlp_ratio: float = 4.0) -> int:
    """Matmul FLOPs of one pre-LN transformer block forward on L tokens."""
    hidden = int(D * mlp_ratio)
    attn = 2 * L * D * (3 * D) + 2 * L * L * D + 2 * L * L * D + 2 * L * D * D
    mlp = 2 * L * D * hidden + 2 * L * hidden * D
    return attn + mlp


def _stack(L: int, D: int, depth: int, mlp_ratio: float = 4.0) -> int:
    return depth * block_flops(L, D, mlp_ratio)


def task_flops_per_image(task, ctx=None) -> int:
    """Training-step FLOPs per image (forward + 2x-forward backward);
    ``ctx`` is the task's ``epoch_context`` (MAE's masked-token count),
    epoch 0's by default."""
    name = type(task).__name__
    if ctx is None:
        ctx = task.epoch_context(0)
    m = task.model
    if name == "MAETask":
        vit, dec = m.encoder.vit, m.decoder
        D, Dd = vit.embed_dim, dec.decoder_embed.out_features
        N = (m.image_size // m.patch_size) ** 2
        L = N + 1
        n_mask = int(ctx)
        L_keep = L - n_mask
        P2C = m.patch_size * m.patch_size * m.in_chans
        fwd = (
            2 * N * P2C * D  # patch embed (pre-gather, all patches)
            + _stack(L_keep, D, len(vit.blocks))
            + 2 * L_keep * D * Dd  # decoder embed
            + _stack(L, Dd, len(dec.decoder_blocks))
            + 2 * n_mask * Dd * P2C  # pixel head (masked rows)
        )
        return 3 * fwd
    if name == "JEPATask":
        enc = m.encoder
        D, depth = enc.embed_dim, len(enc.blocks)
        Dp = m.predictor_proj.in_features
        N = m.num_patches
        L = N + 1
        L_ctx = task.context_size + 1
        M = task.num_blocks * task.block_area
        P2C = m.patch_size * m.patch_size * m.in_chans
        ctx_fwd = (
            2 * N * P2C * D
            + _stack(L_ctx, D, depth)
            + 2 * L_ctx * D * Dp  # predictor embed
            + _stack(L, Dp, len(m.predictor.decoder_blocks))
            + 2 * M * Dp * D  # latent projection head
        )
        target_fwd = 2 * N * P2C * D + _stack(L, D, depth)
        return 3 * ctx_fwd + target_fwd  # the EMA tower runs forward only
    if name == "ClassifierTask":
        D = m.encoder.embed_dim
        N = (m.img_size // m.patch_size) ** 2
        L = N + 1
        P2C = m.patch_size * m.patch_size * m.in_chans
        enc_fwd = 2 * N * P2C * D + _stack(L, D, m.depth)
        head_fwd = 2 * D * 10
        if task._freeze_encoder and not task._unfreeze_last:
            return enc_fwd + 3 * head_fwd  # frozen backbone: forward only
        return 3 * (enc_fwd + head_fwd)
    raise ValueError(f"unknown task type {name}")
