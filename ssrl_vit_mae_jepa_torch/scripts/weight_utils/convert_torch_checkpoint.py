"""Convert reference torch checkpoints (.pt/.ckpt) to JAX-native checkpoints.

Port of ``scripts/weight_utils/convert_torch_checkpoint.py``, without JAX,
flax or msgpack: the kind (MAE, classifier or a bare encoder) is detected
from the keys as the JAX CLI does (``:27-41`` there), the state dict goes
through the port's copies of the torch → flax maps
(``utils/interop.py::mae_state_to_params``, ``classifier_state_to_params``,
``timm_vit_to_params``), and ``utils/flax_msgpack.py::write_native_checkpoint``
writes ``{"params": tree}`` with ``{"kind": "<kind>_weights",
"converted_from": input}``: the file the JAX CLI writes, byte for byte,
which every CLI of either package loads::

    python -m ssrl_vit_mae_jepa_torch.scripts.weight_utils.convert_torch_checkpoint \\
        vit-mae.pt vit-mae.ckpt --depth 4 --decoder_depth 2
"""

from __future__ import annotations

import argparse
from pathlib import Path


def convert(input_path: str, output_path: str, depth: int = 4, decoder_depth: int = 2
            ) -> tuple:
    """Write the native file; returns (kind, {missing, unexpected})."""
    from ssrl_vit_mae_jepa_torch.utils import interop
    from ssrl_vit_mae_jepa_torch.utils.flax_msgpack import write_native_checkpoint
    from ssrl_vit_mae_jepa_torch.utils.load import detect_prefix, load_any, strip_prefix

    _, state, _ = load_any(input_path)
    flat = {k: v.numpy() for k, v in state.items()}
    if any(".decoder_blocks." in k or k.startswith(("decoder.", "model.decoder."))
           for k in flat):
        kind = "mae"
        params, report = interop.mae_state_to_params(flat, depth, decoder_depth)
    elif any("head.classification" in k for k in flat):
        kind = "classifier"
        params, report = interop.classifier_state_to_params(flat, depth)
    else:
        kind = "encoder"
        prefix = detect_prefix(flat) or ""
        params, report = interop.timm_vit_to_params(
            strip_prefix(flat, prefix) if prefix else flat, depth)
        params = {"encoder": params}
    write_native_checkpoint(Path(output_path), {"params": params},
                            {"kind": f"{kind}_weights", "converted_from": str(input_path)})
    return kind, report


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="torch → JAX checkpoint converter")
    parser.add_argument("input", type=str, help="torch .pt/.ckpt path")
    parser.add_argument("output", type=str, help="native .ckpt output path")
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--decoder_depth", type=int, default=2)
    args = parser.parse_args(argv)
    kind, report = convert(args.input, args.output, args.depth, args.decoder_depth)
    print(f"🔎 Detected checkpoint kind: {kind}")
    if report["missing"]:
        print(f"⚠️ Missing: {report['missing']}")
    if report["unexpected"]:
        print(f"⚠️ Unexpected (ignored): {report['unexpected'][:10]}")
    print(f"✅ Wrote {args.output}")
    return kind


if __name__ == "__main__":
    main()
