"""Checkpoint fidelity: the port's models on a reference checkpoint against a
golden torch forward written from the raw state dict.

Port of ``scripts/evaluation/parity_check.py``. For a checkpoint (a timm or
lightly ``.pt``, a Lightning ``.ckpt``, or a JAX-native file) this CLI:

1. loads the weights through the port's loaders (``utils/load.py``: timm and
   lightly names, Lightning's ``state_dict``, the ``model.`` / ``module.`` /
   ``encoder.vit.`` prefixes); the port needs no conversion step;
2. runs the port's models at f32 under no-grad on the CLI's device (on the
   card the blocks take the f32 branch kernels of ``csrc/branch_f32.cu``)
   on a seeded random batch;
3. runs this module's own golden forward of the timm ``forward_features``
   contract (and of the lightly MAE pipeline) from the raw state dict, in
   f32 on the CPU, which neither the card nor TF32 can touch;
4. holds the encoder features to ``tol``, the MAE prediction to ``tol`` with
   the pixel targets exactly equal, and, where the file has a head, the
   logits to ``10 * tol`` with every top-1 the same (mean pooling includes
   CLS, quirk Q6).

The MAE mask comes from a ``torch.Generator`` seeded 42 through
``ops/masking.py`` (JAX's ``PRNGKey(42)`` draws cannot be reproduced);
``check_file(masks=...)`` takes other indices. Exit code 0 when every check
passes, 1 otherwise::

    python -m ssrl_vit_mae_jepa_torch.scripts.evaluation.parity_check \\
        assets/weights/vit-mae.pt --config configs/mae.yaml
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssrl_vit_mae_jepa_torch.utils.load import (
    classifier_params_from_checkpoint,
    detect_prefix,
    encoder_params_from_checkpoint,
    load_any,
    mae_params_from_checkpoint,
    strip_prefix,
)

MASK_SEED = 42
BATCH_SEED = 73


def _tensors(state) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in state.items()}


def _ln(v, w, b):
    return F.layer_norm(v, (v.shape[-1],), w, b, eps=1e-6)


def _torch_block(t, p, x, heads):
    """One pre-LN timm block from raw state-dict tensors at prefix ``p``."""
    B, L, D = x.shape
    hd = D // heads
    y = _ln(x, t[p + "norm1.weight"], t[p + "norm1.bias"])
    qkv = y @ t[p + "attn.qkv.weight"].T + t[p + "attn.qkv.bias"]
    qkv = qkv.reshape(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    att = torch.softmax(q @ k.transpose(-2, -1) / hd**0.5, dim=-1)
    o = (att @ v).transpose(1, 2).reshape(B, L, D)
    x = x + o @ t[p + "attn.proj.weight"].T + t[p + "attn.proj.bias"]
    y = _ln(x, t[p + "norm2.weight"], t[p + "norm2.bias"])
    h = F.gelu(y @ t[p + "mlp.fc1.weight"].T + t[p + "mlp.fc1.bias"])
    return x + h @ t[p + "mlp.fc2.weight"].T + t[p + "mlp.fc2.bias"]


def _embed(t, e, x, patch):
    """timm's conv patch embed, CLS and position embedding at prefix ``e``."""
    tok = F.conv2d(x, t[e + "patch_embed.proj.weight"], t[e + "patch_embed.proj.bias"],
                   stride=patch).flatten(2).transpose(1, 2)
    cls = t[e + "cls_token"].expand(x.shape[0], -1, -1)
    return torch.cat([cls, tok], dim=1) + t[e + "pos_embed"]


@torch.no_grad()
def torch_forward_features(state, x_nchw: np.ndarray, depth: int, num_heads: int,
                           patch_size: int) -> np.ndarray:
    """Golden timm-contract forward in f32 on the CPU, from raw state-dict
    tensors (timm names): (B, L, D) normed tokens."""
    t = _tensors(state)
    x = _embed(t, "", torch.from_numpy(x_nchw), patch_size)
    for i in range(depth):
        x = _torch_block(t, f"blocks.{i}.", x, num_heads)
    return _ln(x, t["norm.weight"], t["norm.bias"]).numpy()


@torch.no_grad()
def torch_mae_forward(state, x_nchw: np.ndarray, idx_keep, idx_mask, *, depth: int,
                      heads: int, dec_depth: int, dec_heads: int, patch: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Golden whole MAE forward in f32 on the CPU from a reference-named
    state dict (``encoder.vit.*`` + ``decoder.*``; reference
    ``src/models/mae.py:77-94``): masked encode → decoder embed →
    mask-token scatter → pos-embed → blocks → norm → gather ``idx_mask`` →
    pixel head; targets are the CHW-within-patch patches at
    ``clamp(idx_mask − 1, 0)``. Returns (pred, target)."""
    t = _tensors(state)
    x = torch.from_numpy(x_nchw)
    ik = torch.as_tensor(np.asarray(idx_keep)).long()
    im = torch.as_tensor(np.asarray(idx_mask)).long()
    B = x.shape[0]
    e = "encoder.vit."
    D = t[e + "cls_token"].shape[-1]
    tok = torch.gather(_embed(t, e, x, patch), 1, ik.unsqueeze(-1).expand(-1, -1, D))
    for i in range(depth):
        tok = _torch_block(t, f"{e}blocks.{i}.", tok, heads)
    enc = _ln(tok, t[e + "norm.weight"], t[e + "norm.bias"])

    d = "decoder."
    dd = t[d + "mask_token"].shape[-1]
    xd = enc @ t[d + "decoder_embed.weight"].T + t[d + "decoder_embed.bias"]
    L = t[d + "decoder_pos_embed"].shape[1]
    full = t[d + "mask_token"].expand(B, L, dd).clone()
    full.scatter_(1, ik.unsqueeze(-1).expand(-1, -1, dd), xd)
    full = full + t[d + "decoder_pos_embed"]
    for i in range(dec_depth):
        full = _torch_block(t, f"{d}decoder_blocks.{i}.", full, dec_heads)
    full = _ln(full, t[d + "decoder_norm.weight"], t[d + "decoder_norm.bias"])
    sel = torch.gather(full, 1, im.unsqueeze(-1).expand(-1, -1, dd))
    pred = sel @ t[d + "decoder_pred.weight"].T + t[d + "decoder_pred.bias"]

    gh = x.shape[-1] // patch
    patches = x.reshape(B, 3, gh, patch, gh, patch).permute(
        0, 2, 4, 1, 3, 5).reshape(B, gh * gh, patch * patch * 3)
    tgt = torch.gather(patches, 1,
                       (im - 1).clamp(min=0).unsqueeze(-1).expand(-1, -1, patches.shape[-1]))
    return pred.numpy(), tgt.numpy()


def encoder_state(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The timm ViT inside a flat state dict, by the JAX CLI's prefix rules
    (``parity_check.py:159-164`` there)."""
    prefix = detect_prefix(flat) or ""
    enc = strip_prefix(flat, prefix) if prefix else flat
    if detect_prefix(enc, ["vit."]):
        enc = strip_prefix(enc, "vit.")
    return enc


def mae_state(flat: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """The ``encoder.*`` + ``decoder.*`` MAE state dict inside a flat one
    (perhaps under ``model.`` or ``module.``), None without a decoder."""
    if not any(k.startswith("decoder.") for k in flat):
        for pref in ("model.", "module."):
            if any(k.startswith(pref + "decoder.") for k in flat):
                return strip_prefix(flat, pref)
        return None
    return flat


def head_weights(flat: Dict[str, torch.Tensor]) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(weight, bias) of the classification head as f32 numpy, None without one."""
    w = [k for k in flat if k.endswith("head.classification.weight")]
    b = [k for k in flat if k.endswith("head.classification.bias")]
    if not (w and b):
        return None
    return (np.asarray(flat[w[0]], np.float32), np.asarray(flat[b[0]], np.float32))


def golden_logits(golden: np.ndarray, head, pool: str) -> np.ndarray:
    """The golden classifier on golden features: pool (mean includes CLS,
    quirk Q6), then the head."""
    pooled = golden[:, 0] if pool == "cls" else golden.mean(axis=1)
    return pooled @ head[0].T + head[1]


def _nhwc(x_nchw: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))).to(device)


@torch.no_grad()
def port_features(model_cfg: dict, weights, x_nchw: np.ndarray, device) -> np.ndarray:
    """The port's ``VisionTransformer`` at f32 on ``device``: (B, L, D)."""
    from ssrl_vit_mae_jepa_torch.models.vit import vit_from_config

    vit = vit_from_config(model_cfg, dtype=torch.float32)
    vit.load_state_dict(weights, strict=True)
    return vit.to(device)(_nhwc(x_nchw, device)).cpu().numpy()


@torch.no_grad()
def port_mae(model_cfg: dict, weights, x_nchw: np.ndarray, idx_keep, idx_mask, device
             ) -> Tuple[np.ndarray, np.ndarray]:
    """The port's ``MaskedAutoencoder`` at f32 on ``device``: (pred, target)."""
    from ssrl_vit_mae_jepa_torch.models.mae import mae_from_config

    mae = mae_from_config(model_cfg, dtype=torch.float32)
    mae.load_state_dict(weights, strict=True)
    ik, im = (torch.as_tensor(np.array(i)).long().to(device) for i in (idx_keep, idx_mask))
    pred, target = mae.to(device)(_nhwc(x_nchw, device), ik, im)
    return pred.cpu().numpy(), target.cpu().numpy()


@torch.no_grad()
def port_logits(model_cfg: dict, weights, x_nchw: np.ndarray, device) -> np.ndarray:
    """The port's ``ViTClassifier`` at f32 on ``device``: (B, classes)."""
    from ssrl_vit_mae_jepa_torch.models.classifier import classifier_from_config

    clf = classifier_from_config(model_cfg, dtype=torch.float32)
    clf.load_state_dict(weights, strict=True)
    return clf.to(device)(_nhwc(x_nchw, device)).cpu().numpy()


def mae_masks(batch: int, sequence_length: int, ratio: float = 0.75):
    """``(idx_keep, idx_mask)`` from a CPU ``torch.Generator`` seeded
    ``MASK_SEED`` (the same on every device)."""
    from ssrl_vit_mae_jepa_torch.ops.masking import num_masked_tokens, random_token_mask

    return random_token_mask(torch.Generator().manual_seed(MASK_SEED), batch,
                             sequence_length, num_masked_tokens(sequence_length, ratio))


def check_file(checkpoint, cfg: dict, batch: int = 8, tol: float = 1e-3, masks=None) -> bool:
    """Golden-check one checkpoint: the encoder features always, the whole
    MAE (pred, target) pipeline where the file has a decoder, the logits and
    top-1 agreement where it has a head, on the CLI's device
    (``scripts/utils.py::device``). ``masks`` = (idx_keep, idx_mask)
    replaces the seeded MAE mask. True when every applicable check passes;
    a loader that misses keys raises ``SystemExit`` with its report."""
    from ssrl_vit_mae_jepa_torch.scripts.utils import device as cli_device

    device = cli_device()
    model_cfg = cfg["model"]
    depth = model_cfg["encoder"]["depth"]
    heads = model_cfg["encoder"]["num_heads"]
    p = model_cfg["general"]["patch_size"]

    _, flat, _ = load_any(checkpoint)
    enc, report = encoder_params_from_checkpoint(checkpoint, depth)
    if report["missing"]:
        raise SystemExit(f"❌ loader missing keys: {report['missing']}")

    img_size = model_cfg["general"]["image_size"]
    x = np.random.default_rng(BATCH_SEED).normal(
        0, 1, (batch, 3, img_size, img_size)).astype(np.float32)
    golden = torch_forward_features(encoder_state(flat), x, depth, heads, p)
    ours = port_features(model_cfg, enc, x, device)
    err = np.abs(ours - golden)
    rel = err.max() / max(np.abs(golden).max(), 1e-9)
    print(f"🔬 encoder features: max abs err {err.max():.3e} "
          f"(rel {rel:.3e}, mean {err.mean():.3e})")
    ok = bool(err.max() < tol)

    mae_flat = mae_state(flat)
    if mae_flat is not None:
        dec_depth = model_cfg["decoder"]["decoder_depth"]
        dec_heads = model_cfg["decoder"]["decoder_num_heads"]
        weights, mrep = mae_params_from_checkpoint(checkpoint, depth, dec_depth)
        if mrep["missing"]:
            raise SystemExit(f"❌ MAE loader missing keys: {mrep['missing']}")
        idx_keep, idx_mask = masks if masks is not None else mae_masks(
            batch, (img_size // p) ** 2 + 1)
        pred, target = port_mae(model_cfg, weights, x, idx_keep, idx_mask, device)
        g_pred, g_target = torch_mae_forward(
            mae_flat, x, np.asarray(idx_keep), np.asarray(idx_mask), depth=depth, heads=heads,
            dec_depth=dec_depth, dec_heads=dec_heads, patch=p)
        derr = np.abs(pred - g_pred).max()
        terr = np.abs(target - g_target).max()
        print(f"🔬 MAE decoder pred: max abs err {derr:.3e}; "
              f"pixel targets: max abs err {terr:.3e}")
        ok = ok and bool(derr < tol) and terr == 0.0

    head = head_weights(flat)
    if head is not None:
        weights, _, _ = classifier_params_from_checkpoint(checkpoint, depth)
        logits = port_logits(model_cfg, weights, x, device)
        want = golden_logits(golden, head, model_cfg.get("head", {}).get("pool", "cls"))
        lerr = np.abs(logits - want).max()
        agree = (logits.argmax(1) == want.argmax(1)).mean()
        print(f"🔬 classifier logits: max abs err {lerr:.3e}, top-1 agreement {agree:.1%}")
        ok = ok and bool(lerr < 10 * tol) and agree == 1.0

    print("✅ PARITY OK" if ok else "❌ PARITY FAILED")
    return ok


def main(argv=None) -> bool:
    parser = argparse.ArgumentParser(description="Verify a checkpoint's fidelity in the port")
    parser.add_argument("checkpoint", type=str, help="reference .pt/.ckpt or a JAX-native file")
    parser.add_argument("--config", type=str, default="configs/mae.yaml")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--tol", type=float, default=1e-3)
    args = parser.parse_args(argv)

    from ssrl_vit_mae_jepa_torch.config import load_config
    from ssrl_vit_mae_jepa_torch.scripts.utils import setup_reproducibility, shut_down_warnings

    shut_down_warnings()
    setup_reproducibility(seed=73)
    ok = check_file(args.checkpoint, load_config(args.config), batch=args.batch, tol=args.tol)
    if not ok:
        raise SystemExit(1)
    return ok


if __name__ == "__main__":
    main()
