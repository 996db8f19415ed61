"""Checkpoint loading with prefix detection.

Port of ``ssrl_vit_mae_jepa_tpu/utils/load.py`` (reference
``scripts/utils.py:40-148``): the port's own checkpoints
(``utils/checkpoint.py``), the reference's Lightning ``.ckpt`` and ``.pt``
state dicts, the JAX package's exports (``export_reference_weights``,
``convert_to_torch``) and its native checkpoints: a trainer ``.ckpt`` or a
weights ``.pt`` as flax msgpack in a zip, read by ``utils/flax_msgpack.py``
(no msgpack, flax or JAX needed) and mapped to the reference's names by
``utils/interop.py``. Each loader returns state dicts by the port's (the
reference's) names, as CPU f32 tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ssrl_vit_mae_jepa_torch.utils import interop
from ssrl_vit_mae_jepa_torch.utils.flax_msgpack import is_native_zip, read_native_checkpoint
from ssrl_vit_mae_jepa_torch.utils.interop import (
    ENCODER_PREFIXES,
    _decoder_entries,
    _vit_entries,
    detect_prefix,
    strip_prefix,
)

State = Dict[str, torch.Tensor]


def detect_kind(params: dict) -> str:
    """The model a JAX params tree holds, as
    ``scripts/weight_utils/convert_to_torch.py::detect_kind`` decides it:
    ``mae`` (a decoder), ``classifier`` (a head), else ``encoder`` (a ViT,
    the JEPA's context encoder for a JEPA tree)."""
    if "decoder" in params:
        return "mae"
    if "head" in params:
        return "classifier"
    return "encoder"


def numpy_tree(tree):
    """A decoded tree with its tensors as f32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.float().numpy() if torch.is_tensor(tree) else tree


def native_params(path: str | Path) -> Tuple[dict, dict]:
    """The ``params`` tree of a JAX-native checkpoint (a trainer ``.ckpt``
    or a weights file), as nested dicts of f32 numpy arrays, and its meta
    (``_native_params`` of the JAX package's ``utils/load.py``)."""
    state, meta = read_native_checkpoint(path)
    if not (isinstance(state, dict) and "params" in state):
        raise ValueError(f"native checkpoint {path} has no params tree")
    return numpy_tree(state["params"]), meta


def native_state(params: dict, kind: str = "auto") -> Dict[str, np.ndarray]:
    """A JAX params tree by the reference's names: the MAE's (lightly),
    the classifier's, or the bare timm encoder (``params["encoder"]`` where
    the tree has one), as ``convert_to_torch`` writes each."""
    if kind == "auto":
        kind = detect_kind(params)
    if kind == "mae":
        return interop.mae_params_to_state(params)
    if kind == "classifier":
        return interop.classifier_params_to_state(params)
    if kind == "encoder":
        return interop.vit_params_to_state(params.get("encoder", params))
    raise ValueError(f"unknown kind: {kind}")


def load_any(path: str | Path) -> Tuple[str, State, dict]:
    """→ ("native", state dict, meta.json) for a JAX-native checkpoint,
    ("torch", flat state dict, meta) otherwise: Lightning's ``state_dict``
    is unwrapped (reference ``train_mae.py:103``), and ``meta`` holds the
    file's other entries (epoch, callbacks, ...) where it has them."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(
            f"Checkpoint not found: {path}: expected a JAX-native .ckpt, a torch "
            ".pt/.ckpt or a weights export (see scripts.weight_utils)")
    if is_native_zip(path):
        params, meta = native_params(path)
        state = native_state(params)
        return "native", {k: torch.from_numpy(v) for k, v in state.items()}, meta
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    meta: dict = {}
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        meta = {k: v for k, v in ckpt.items() if k != "state_dict"}
        ckpt = ckpt["state_dict"]
    state = {k: v.detach().float() if torch.is_tensor(v) else torch.as_tensor(v)
             for k, v in ckpt.items()}
    return "torch", state, meta


def _vit_names(depth: int) -> List[str]:
    return [k for k, _, _ in _vit_entries(depth)]


def _report(state: State, want: List[str]) -> dict:
    return {"missing": [k for k in want if k not in state],
            "unexpected": sorted(set(state) - set(want))}


def _timm_vit(state: State, depth: int) -> Tuple[State, dict]:
    """A timm ViT state dict (lightly's ``vit.`` prefix accepted) → the
    port's ``VisionTransformer`` names and a missing/unexpected report."""
    if detect_prefix(state, ["vit."]):
        state = {k[len("vit."):] if k.startswith("vit.") else k: v for k, v in state.items()}
    want = _vit_names(depth)
    return {k: state[k] for k in want if k in state}, _report(state, want)


def encoder_params_from_checkpoint(path: str | Path, depth: int) -> Tuple[State, dict]:
    """The ViT encoder of any checkpoint, by timm names → (state, report)
    (reference ``scripts/training/train_mae.py:92-146``). Besides the
    prefixed files it takes a bare timm ViT (no prefix), which is what both
    packages' JEPA CLI writes as ``vit-jepa.pt``; the JAX package's loader
    refuses that file."""
    _, state, _ = load_any(path)
    prefix = detect_prefix(state)
    if prefix is None and "cls_token" in state:
        prefix = ""  # a bare timm ViT: the JEPA CLI's vit-jepa.pt
    if prefix is None:
        raise ValueError("Could not find encoder weights in checkpoint. Expected keys "
                         "starting with one of: " + ", ".join(ENCODER_PREFIXES)
                         + ", or a bare timm ViT (cls_token, blocks.*)")
    print(f"Detected encoder prefix in checkpoint: '{prefix}'")
    enc, report = _timm_vit(strip_prefix(state, prefix), depth)
    print(f"Loaded encoder weights: {len(enc)} tensors ({len(report['missing'])} missing, "
          f"{len(report['unexpected'])} unexpected)")
    return enc, report


def classifier_params_from_checkpoint(path: str | Path, depth: int
                                      ) -> Tuple[State, dict, dict]:
    """A whole ``ViTClassifier`` state dict (``encoder.*`` timm keys and
    ``head.classification.*``, perhaps under ``model.``) → (state, report,
    meta)."""
    _, state, meta = load_any(path)
    if detect_prefix(state, ["model."]):
        state = strip_prefix(state, "model.")
    enc, report = _timm_vit(strip_prefix(state, "encoder."), depth)
    out = {f"encoder.{k}": v for k, v in enc.items()}
    for k in ("head.classification.weight", "head.classification.bias"):
        if k in state:
            out[k] = state[k]
        else:
            report["missing"].append(k)
    return out, report, meta


def mae_params_from_checkpoint(path: str | Path, depth: int, decoder_depth: int
                               ) -> Tuple[State, dict]:
    """A whole ``MaskedAutoencoder`` state dict (``encoder.vit.*``,
    ``encoder.mask_token`` and ``decoder.*``, perhaps under ``model.``)."""
    _, state, _ = load_any(path)
    if detect_prefix(state, ["model."]):
        state = strip_prefix(state, "model.")
    enc, report = _timm_vit(strip_prefix(state, "encoder."), depth)
    dec_state = strip_prefix(state, "decoder.")
    dec_want = [k for k, _, _ in _decoder_entries(decoder_depth)]
    dec_report = _report(dec_state, dec_want)
    out = {f"encoder.vit.{k}": v for k, v in enc.items()}
    out["encoder.mask_token"] = state.get("encoder.mask_token",
                                          torch.zeros_like(enc["cls_token"]))
    out.update({f"decoder.{k}": dec_state[k] for k in dec_want if k in dec_state})
    report["unexpected"] = [k for k in report["unexpected"] if k != "mask_token"]
    return out, {"missing": report["missing"] + dec_report["missing"],
                 "unexpected": report["unexpected"] + dec_report["unexpected"]}


def merge_encoder(params: State, encoder_params: State) -> State:
    """``params`` (a classifier's state dict) with its ``encoder.`` tensors
    replaced by ``encoder_params`` (timm names), shape-checked and cast to
    the classifier's dtypes (``utils/load.py:102-114`` of the JAX package)."""
    merged = dict(params)
    enc = strip_prefix(params, "encoder.")
    if set(enc) != set(encoder_params):
        raise ValueError(f"encoder tensors differ: missing "
                         f"{sorted(set(enc) - set(encoder_params))}, unexpected "
                         f"{sorted(set(encoder_params) - set(enc))}")
    for k, a in enc.items():
        b = torch.as_tensor(encoder_params[k])
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"encoder shape mismatch at {k}: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        merged[f"encoder.{k}"] = b.to(dtype=a.dtype, device=a.device)
    return merged
