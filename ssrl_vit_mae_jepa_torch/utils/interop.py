"""Weights from the JAX package into the port.

The JAX package's params are a nested dict of arrays in flax names and
layouts; the port's modules use the reference's torch (timm/lightly) names,
so crossing over is one export and one strict ``load_state_dict``. The
export is this module's own numpy copy of
``ssrl_vit_mae_jepa_tpu/utils/torch_interop.py::mae_params_to_state`` and
``classifier_params_to_state`` and the tables they walk (:89-106,
:209-321), and the JEPA export built from the same tables (the JAX package
has none); the port imports nothing of the JAX package.

The other way, ``export_reference_weights`` writes a port model's weights as
the reference's terminal ``.pt`` file, as the JAX package's
``utils/torch_interop.py::export_reference_weights`` (:324-343) does; the
port's modules already carry the reference names, so it is a ``torch.save``.
And ``timm_vit_to_params``, ``lightly_decoder_to_params``,
``mae_state_to_params`` and ``classifier_state_to_params`` are copies of
the JAX package's torch → flax maps (``utils/torch_interop.py:125-196``),
with their reports of missing and unexpected keys, over the same tables:
``scripts/weight_utils/convert_torch_checkpoint.py`` writes their trees as
JAX-native checkpoints.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

ENCODER_PREFIXES = ["model.encoder.", "encoder.", "module.encoder."]


def detect_prefix(keys: Iterable[str], candidates: List[str] = ENCODER_PREFIXES
                  ) -> Optional[str]:
    """The first candidate prefix present among ``keys``."""
    keys = list(keys)
    for p in candidates:
        if any(k.startswith(p) for k in keys):
            return p
    return None


def strip_prefix(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _block_entries(i: int, torch_prefix: str, flax_name: str):
    """(torch key, flax path, layout transform) for one transformer block."""
    tb = f"{torch_prefix}.{i}."
    fb = [flax_name]
    return [
        (tb + "norm1.weight", fb + ["norm1", "scale"], None),
        (tb + "norm1.bias", fb + ["norm1", "bias"], None),
        (tb + "attn.qkv.weight", fb + ["attn", "qkv", "kernel"], "T"),
        (tb + "attn.qkv.bias", fb + ["attn", "qkv", "bias"], None),
        (tb + "attn.proj.weight", fb + ["attn", "proj", "kernel"], "T"),
        (tb + "attn.proj.bias", fb + ["attn", "proj", "bias"], None),
        (tb + "norm2.weight", fb + ["norm2", "scale"], None),
        (tb + "norm2.bias", fb + ["norm2", "bias"], None),
        (tb + "mlp.fc1.weight", fb + ["mlp", "fc1", "kernel"], "T"),
        (tb + "mlp.fc1.bias", fb + ["mlp", "fc1", "bias"], None),
        (tb + "mlp.fc2.weight", fb + ["mlp", "fc2", "kernel"], "T"),
        (tb + "mlp.fc2.bias", fb + ["mlp", "fc2", "bias"], None),
    ]


def _vit_entries(depth: int):
    entries = [
        ("cls_token", ["cls_token"], None),
        ("pos_embed", ["pos_embed"], None),
        ("patch_embed.proj.weight", ["patch_embed", "kernel"], "patch"),
        ("patch_embed.proj.bias", ["patch_embed", "bias"], None),
        ("norm.weight", ["norm", "scale"], None),
        ("norm.bias", ["norm", "bias"], None),
    ]
    for i in range(depth):
        entries += _block_entries(i, "blocks", f"blocks_{i}")
    return entries


def _decoder_entries(depth: int, with_pred: bool = True):
    entries = [
        ("decoder_embed.weight", ["decoder_embed", "kernel"], "T"),
        ("decoder_embed.bias", ["decoder_embed", "bias"], None),
        ("mask_token", ["mask_token"], None),
        ("decoder_pos_embed", ["decoder_pos_embed"], None),
        ("decoder_norm.weight", ["decoder_norm", "scale"], None),
        ("decoder_norm.bias", ["decoder_norm", "bias"], None),
    ]
    if with_pred:
        entries += [
            ("decoder_pred.weight", ["decoder_pred", "kernel"], "T"),
            ("decoder_pred.bias", ["decoder_pred", "bias"], None),
        ]
    for i in range(depth):
        entries += _block_entries(i, "decoder_blocks", f"decoder_blocks_{i}")
    return entries


def _get(tree: dict, path: List[str]):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _set(tree: dict, path: List[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _import_entries(state: Dict[str, np.ndarray], entries) -> Tuple[dict, dict]:
    """A torch-named state dict → (flax tree, {missing, unexpected}), the
    inverse of :func:`_export_entries`; the tree's dicts fill in the
    tables' order, as the JAX package's ``_apply_entries`` fills them."""
    tree: dict = {}
    missing = []
    for torch_key, flax_path, tform in entries:
        if torch_key not in state:
            missing.append(torch_key)
            continue
        v = state[torch_key]
        if tform == "T":
            v = np.ascontiguousarray(v.T)
        elif tform == "patch":
            # the conv weight (D, C, p, p) → the patchify-matmul kernel (C·p·p, D)
            v = np.ascontiguousarray(v.reshape(v.shape[0], -1).T)
        _set(tree, flax_path, v)
    used = {k for k, _, _ in entries}
    return tree, {"missing": missing, "unexpected": sorted(set(state) - used)}


def timm_vit_to_params(state: Dict[str, np.ndarray], depth: int) -> Tuple[dict, dict]:
    """A timm ViT state dict (numpy, lightly's ``vit.`` prefix accepted) →
    (flax ``VisionTransformer`` params, {missing, unexpected})."""
    if detect_prefix(state, ["vit."]):
        state = {k[len("vit."):] if k.startswith("vit.") else k: v for k, v in state.items()}
    return _import_entries(state, _vit_entries(depth))


def lightly_decoder_to_params(state: Dict[str, np.ndarray], depth: int
                              ) -> Tuple[dict, dict]:
    """A lightly ``MAEDecoderTIMM`` state dict → flax ``MAEDecoder`` params."""
    return _import_entries(state, _decoder_entries(depth))


def mae_state_to_params(state: Dict[str, np.ndarray], depth: int, decoder_depth: int
                        ) -> Tuple[dict, dict]:
    """A whole MAE state dict (``encoder.*`` + ``decoder.*``, perhaps under
    Lightning's ``model.``) → ``MaskedAutoencoder`` params; lightly's
    encoder ``mask_token`` is reported as unexpected."""
    if detect_prefix(state, ["model."]):
        state = strip_prefix(state, "model.")
    enc, enc_rep = timm_vit_to_params(strip_prefix(state, "encoder."), depth)
    dec, dec_rep = lightly_decoder_to_params(strip_prefix(state, "decoder."), decoder_depth)
    return {"encoder": enc, "decoder": dec}, {
        "missing": enc_rep["missing"] + dec_rep["missing"],
        "unexpected": enc_rep["unexpected"] + dec_rep["unexpected"]}


def classifier_state_to_params(state: Dict[str, np.ndarray], depth: int
                               ) -> Tuple[dict, dict]:
    """A ``ViTClassifier`` state dict (``encoder.*`` timm keys and
    ``head.classification.*``, perhaps under ``model.``) → its params."""
    if detect_prefix(state, ["model."]):
        state = strip_prefix(state, "model.")
    enc, report = timm_vit_to_params(strip_prefix(state, "encoder."), depth)
    tree = {"encoder": enc}
    for name, leaf, tform in (("weight", "kernel", "T"), ("bias", "bias", None)):
        key = f"head.classification.{name}"
        if key in state:
            v = state[key]
            _set(tree, ["head", "classification", leaf],
                 np.ascontiguousarray(v.T) if tform else v)
        else:
            report["missing"].append(key)
    return tree, report


def _export_entries(params: dict, entries, in_chans: int = 3) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for torch_key, flax_path, tform in entries:
        v = _get(params, flax_path)
        if v is None:
            raise KeyError(
                f"export: flax param {'/'.join(flax_path)} (→ {torch_key}) missing"
            )
        v = np.asarray(v, dtype=np.float32)
        if tform == "T":
            v = np.ascontiguousarray(v.T)
        elif tform == "patch":
            # invert the C-major flatten of the patchify-matmul kernel:
            # (p*p*C, D) → (D, C, p, p)
            p2c, D = v.shape
            p = int(round((p2c // in_chans) ** 0.5))
            v = np.ascontiguousarray(v.T.reshape(D, in_chans, p, p))
        out[torch_key] = v
    return out


def _depth(params: dict, block_prefix: str) -> int:
    return sum(1 for k in params if k.startswith(block_prefix))


def mae_params_to_state(params: dict, in_chans: int = 3) -> Dict[str, np.ndarray]:
    """MaskedAutoencoder params → the reference's ``vit-mae.pt`` names: timm
    keys under ``encoder.vit.``, lightly's unused encoder ``mask_token`` as
    zeros, ``MAEDecoderTIMM`` keys under ``decoder.``."""
    enc_p, dec_p = params["encoder"], params["decoder"]
    enc = _export_entries(enc_p, _vit_entries(_depth(enc_p, "blocks_")), in_chans)
    dec = _export_entries(dec_p, _decoder_entries(_depth(dec_p, "decoder_blocks_")))
    out = {f"encoder.vit.{k}": v for k, v in enc.items()}
    out["encoder.mask_token"] = np.zeros((1, 1, enc["cls_token"].shape[-1]), np.float32)
    out.update({f"decoder.{k}": v for k, v in dec.items()})
    return out


def _load_strict(model: torch.nn.Module, state: Dict[str, np.ndarray]) -> torch.nn.Module:
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()},
        strict=True,
    )
    return model


def mae_params_from_jax(params: dict, model: torch.nn.Module) -> torch.nn.Module:
    """Load MaskedAutoencoder params (a tree of numpy arrays) into the port's
    ``MaskedAutoencoder`` with ``strict=True``; returns ``model``."""
    return _load_strict(model, mae_params_to_state(params))


def vit_params_to_state(params: dict, in_chans: int = 3) -> Dict[str, np.ndarray]:
    """A flax ``VisionTransformer`` tree (e.g. JEPA's EMA ``extra``) → the
    port's ViT names (timm's), as ``state.extra`` holds them."""
    return _export_entries(params, _vit_entries(_depth(params, "blocks_")), in_chans)


def jepa_params_to_state(params: dict, in_chans: int = 3) -> Dict[str, np.ndarray]:
    """JEPA params → the port's ``JEPA`` names: the ViT under ``encoder.``,
    the predictor's decoder names (no ``decoder_pred``) under ``predictor.``
    and ``predictor_proj.``. The JAX package has no JEPA converter; this one
    is built from the same tables."""
    pred_p = params["predictor"]
    pred = _export_entries(pred_p, _decoder_entries(_depth(pred_p, "decoder_blocks_"),
                                                    with_pred=False))
    proj = _export_entries(params, [
        ("predictor_proj.weight", ["predictor_proj", "kernel"], "T"),
        ("predictor_proj.bias", ["predictor_proj", "bias"], None),
    ])
    out = {f"encoder.{k}": v for k, v in vit_params_to_state(params["encoder"], in_chans).items()}
    out.update({f"predictor.{k}": v for k, v in pred.items()})
    out.update(proj)
    return out


def jepa_params_from_jax(params: dict, model: torch.nn.Module) -> torch.nn.Module:
    """Load JEPA params (a tree of numpy arrays) into the port's ``JEPA``
    with ``strict=True``; returns ``model``."""
    return _load_strict(model, jepa_params_to_state(params))


def classifier_params_to_state(params: dict, in_chans: int = 3) -> Dict[str, np.ndarray]:
    """ViTClassifier params → the reference's classifier names: timm keys
    under ``encoder.`` and ``head.classification.{weight,bias}``."""
    out = {f"encoder.{k}": v for k, v in vit_params_to_state(params["encoder"], in_chans).items()}
    out.update(_export_entries(params, [
        ("head.classification.weight", ["head", "classification", "kernel"], "T"),
        ("head.classification.bias", ["head", "classification", "bias"], None),
    ]))
    return out


def classifier_params_from_jax(params: dict, model: torch.nn.Module) -> torch.nn.Module:
    """Load ViTClassifier params (a tree of numpy arrays) into the port's
    ``ViTClassifier`` with ``strict=True``; returns ``model``."""
    return _load_strict(model, classifier_params_to_state(params))


def export_reference_weights(path: str | Path, state: Dict[str, torch.Tensor]) -> Path:
    """``torch.save`` a reference-named state dict as f32 CPU tensors: the
    MAE's (lightly names, ``encoder.mask_token`` included), the classifier's
    (``encoder.*``, ``head.classification.*``) or a bare encoder's (timm
    names, the JEPA CLI's ``vit-jepa.pt``). The file equals the JAX
    package's export of the same parameters, key for key and bit for bit."""
    path = Path(path)
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous().clone()
                for k, v in state.items()}, str(path))
    return path
