"""STL-10 provisioning CLI (port of ``scripts/data.py``): download the three
splits into ``data/stl10_binary``, or, offline, write a synthetic dataset in
the same binary format (``--synthetic``, ``data/stl10.py``)."""

from __future__ import annotations

import argparse
from pathlib import Path

ROOT_DIR = Path(__file__).resolve().parents[2]
DATA_DIR = ROOT_DIR / "data"


def main(argv=None):
    parser = argparse.ArgumentParser(description="Provision the STL-10 dataset")
    parser.add_argument("--data_dir", type=str, default=str(DATA_DIR))
    parser.add_argument("--synthetic", action="store_true",
                        help="fabricate a synthetic dataset (offline environments)")
    parser.add_argument("--synthetic_train", type=int, default=5000)
    parser.add_argument("--synthetic_test", type=int, default=8000)
    parser.add_argument("--synthetic_unlabeled", type=int, default=100000)
    parser.add_argument(
        "--signal", type=str, default="linear", choices=["linear", "texture"],
        help="synthetic class signal: 'linear' (pixel-decodable; plumbing tests) or "
             "'texture' (matched-statistics oriented gratings, the representation "
             "instrument, see data/stl10.py)")
    args = parser.parse_args(argv)

    from ssrl_vit_mae_jepa_torch.data.stl10 import download_stl10, write_synthetic_stl10

    if args.synthetic:
        d = write_synthetic_stl10(args.data_dir, num_train=args.synthetic_train,
                                  num_test=args.synthetic_test,
                                  num_unlabeled=args.synthetic_unlabeled,
                                  class_signal=args.signal)
        print(f"Synthetic STL-10 written to: {d}")
        return d
    d = download_stl10(args.data_dir)
    print(f"All splits downloaded. Dataset is stored in: {d}")
    return d


if __name__ == "__main__":
    main()
