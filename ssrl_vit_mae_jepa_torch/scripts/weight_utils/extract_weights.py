"""Strip training state from checkpoints → pure weight files (port of
``scripts/weight_utils/extract_weights.py``): for every ``.ckpt`` in
``assets/weights/``, write a ``.pt`` holding only the model weights. The
port's own checkpoints lose the optimizer, generator and ``model.`` prefix
(the reference-named state dict of ``export_reference_weights``); the
reference's Lightning checkpoints shed their wrapper and keep their keys.
A JAX-native checkpoint (``utils/load.py::load_any``) is exported by the
reference names, as the JAX package's own export writes it."""

from __future__ import annotations

import argparse
from pathlib import Path


def extract(ckpt_path: Path, out_path: Path) -> Path:
    from ssrl_vit_mae_jepa_torch.utils.checkpoint import FORMAT_KEY, MODEL_PREFIX
    from ssrl_vit_mae_jepa_torch.utils.interop import export_reference_weights
    from ssrl_vit_mae_jepa_torch.utils.load import load_any, strip_prefix

    _, state, meta = load_any(ckpt_path)
    if meta.get("__format__") == FORMAT_KEY:
        state = strip_prefix(state, MODEL_PREFIX)
    export_reference_weights(out_path, state)
    print(f"{ckpt_path} → {out_path}")
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Extract pure weights from checkpoints")
    parser.add_argument("--weights_dir", type=str, default="assets/weights")
    args = parser.parse_args(argv)
    weights_dir = Path(args.weights_dir)
    ckpts = sorted(weights_dir.glob("*.ckpt"))
    if not ckpts:
        print(f"No .ckpt files found in {weights_dir}")
    return [extract(c, c.with_suffix(".pt")) for c in ckpts]


if __name__ == "__main__":
    main()
