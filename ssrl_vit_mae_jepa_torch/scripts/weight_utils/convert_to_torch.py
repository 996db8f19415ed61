"""Convert JAX-native checkpoints to reference-style torch ``.pt`` files.

Port of ``scripts/weight_utils/convert_to_torch.py``, without JAX, flax or
msgpack: the native file (a trainer ``.ckpt`` or an extracted weights
``.pt``) is read by ``utils/flax_msgpack.py`` and written as a
``torch.save`` state dict by the reference's parameter names, the same file
the JAX CLI writes:

  * ``mae``        → ``encoder.vit.*`` + ``encoder.mask_token`` + ``decoder.*``
  * ``classifier`` → ``encoder.*`` + ``head.classification.{weight,bias}``
  * ``encoder``    → bare timm ViT names (``cls_token``, ``blocks.{i}.*``, …)

The kind is detected from the param tree unless ``--kind`` names it::

    python -m ssrl_vit_mae_jepa_torch.scripts.weight_utils.convert_to_torch in.ckpt out.pt
"""

from __future__ import annotations

import argparse
from pathlib import Path


def convert(ckpt_path: Path, out_path: Path, kind: str = "auto") -> str:
    import torch

    from ssrl_vit_mae_jepa_torch.utils.flax_msgpack import is_native_zip, read_native_checkpoint
    from ssrl_vit_mae_jepa_torch.utils.load import detect_kind, native_state, numpy_tree

    if not is_native_zip(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is not a native checkpoint: torch files need no conversion")
    state, _ = read_native_checkpoint(ckpt_path)
    params = numpy_tree(state.get("params", state))
    if kind == "auto":
        kind = detect_kind(params)
    torch_state = native_state(params, kind)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(v.copy()) for k, v in torch_state.items()}, str(out_path))
    return kind


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="JAX → torch checkpoint converter")
    parser.add_argument("input", help="native checkpoint (.ckpt/.pt)")
    parser.add_argument("output", help="torch .pt output path")
    parser.add_argument("--kind", default="auto",
                        choices=["auto", "mae", "classifier", "encoder"])
    args = parser.parse_args(argv)
    kind = convert(Path(args.input), Path(args.output), args.kind)
    print(f"Checkpoint kind: {kind}")
    print(f"Wrote torch state dict: {args.output}")
    return kind


if __name__ == "__main__":
    main()
