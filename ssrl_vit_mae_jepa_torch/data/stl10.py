"""STL-10 binary reader + split logic (torchvision-free, memmap-based).

The PyTorch port's own copy of ``ssrl_vit_mae_jepa_tpu/data/stl10.py``
(framework-free; the split indices and the synthetic writer's bytes are
held equal to the JAX package's by ``tests/test_torch_engine.py``).

Replaces ``torchvision.datasets.STL10`` (reference ``src/data.py:60-65``) with
a direct numpy memmap over the published binary format:

- ``{split}_X.bin``: uint8, per image 3×96×96 stored **column-major within
  channel** — raw layout (N, C, W, H); torchvision reads it as
  ``reshape(-1, 3, 96, 96).transpose(0, 1, 3, 2)`` → (N, C, H, W). We
  produce NHWC uint8 batches (augmentation runs on the device).
- ``{split}_y.bin``: uint8 labels 1..10 (train/test only) → 0..9.
- splits: train 5 000, test 8 000, unlabeled 100 000.

Split semantics match the reference bit-for-bit where it used numpy and
deterministically (documented) where it used torch:

- fraction subsetting is **first-n, not random** (quirk Q4, ``src/data.py:37-42``),
- the labeled stratified split re-creates ``np.random.default_rng(seed)``
  *inside* the per-class loop, so every class is shuffled with the identical
  stream (quirk Q5, ``src/data.py:131-135``) — reproduced exactly,
- the pretrain train/val split is a seeded random permutation (the reference
  used ``torch.Generator().manual_seed(seed)`` + ``random_split``,
  ``src/data.py:76-80``; we use ``np.random.default_rng(seed).permutation`` —
  same distribution, different bits, deliberately torch-free).

Also provides ``write_synthetic_stl10`` so tests and the zero-egress CI
environment can fabricate datasets in the exact binary format.
"""

from __future__ import annotations

import tarfile
import urllib.request
from pathlib import Path
from typing import Tuple

import numpy as np

IMAGE_SIZE = 96
CHANNELS = 3
BYTES_PER_IMAGE = CHANNELS * IMAGE_SIZE * IMAGE_SIZE
SPLIT_SIZES = {"train": 5000, "test": 8000, "unlabeled": 100000}
CLASSES = [
    "airplane", "bird", "car", "cat", "deer",
    "dog", "horse", "monkey", "ship", "truck",
]
URL = "http://ai.stanford.edu/~acoates/stl10/stl10_binary.tar.gz"


def _binary_dir(root: Path) -> Path:
    root = Path(root)
    sub = root / "stl10_binary"
    return sub if sub.exists() else root


class STL10:
    """Memmap-backed STL-10 split: images as NHWC uint8 on demand."""

    def __init__(self, root: str | Path, split: str = "train"):
        if split not in SPLIT_SIZES:
            raise ValueError(f"unknown split {split!r}")
        self.root = Path(root)
        self.split = split
        d = _binary_dir(self.root)
        x_path = d / f"{split}_X.bin"
        if not x_path.exists():
            raise FileNotFoundError(
                f"{x_path} not found — run `python -m scripts.data` to download "
                "or `write_synthetic_stl10` to fabricate a test dataset"
            )
        raw = np.memmap(x_path, dtype=np.uint8, mode="r")
        n = raw.size // BYTES_PER_IMAGE
        # raw layout (N, C, W, H); see module docstring.
        self._raw = raw.reshape(n, CHANNELS, IMAGE_SIZE, IMAGE_SIZE)
        y_path = d / f"{split}_y.bin"
        if y_path.exists() and split != "unlabeled":
            self.labels = (
                np.fromfile(y_path, dtype=np.uint8).astype(np.int32) - 1
            )
        else:
            self.labels = np.full(n, -1, dtype=np.int32)
        self.classes = list(CLASSES)

    def __len__(self) -> int:
        return self._raw.shape[0]

    def images_nhwc(self, indices: np.ndarray) -> np.ndarray:
        """Gather images at ``indices`` → (B, H, W, C) uint8 contiguous.

        Uses the native threaded gather+transpose kernel (``runtime/
        batch_gather.cpp``) when built; numpy fallback otherwise.
        """
        from ssrl_vit_mae_jepa_torch.runtime.native import gather_nhwc

        return gather_nhwc(self._raw, np.asarray(indices))


def subset_first_n(n_total: int, fraction: float) -> np.ndarray:
    """First-n fraction subset — quirk Q4 (reference ``src/data.py:37-42``)."""
    if fraction < 1.0:
        return np.arange(int(n_total * fraction))
    return np.arange(n_total)


def pretrain_split_indices(
    n_total: int, fraction: float, val_split: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Unlabeled split → (train_idx, val_idx), reference ``src/data.py:45-81``."""
    pool = subset_first_n(n_total, fraction)
    n = len(pool)
    n_val = int(n * val_split)
    n_train = n - n_val
    perm = np.random.default_rng(seed).permutation(n)
    return pool[perm[:n_train]], pool[perm[n_train:]]


def stratified_split_indices(
    labels: np.ndarray, samples_per_class: int, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled split → (train_idx, val_idx).

    Bit-exact re-implementation of reference ``src/data.py:128-137``: per
    class, shuffle with a **freshly created** ``np.random.default_rng(seed)``
    (quirk Q5), take the first ``samples_per_class`` for train, rest for val.
    """
    train_indices, val_indices = [], []
    for c in np.unique(labels):
        cls_idx = np.where(labels == c)[0]
        np.random.default_rng(seed).shuffle(cls_idx)
        train_indices.extend(cls_idx[:samples_per_class])
        val_indices.extend(cls_idx[samples_per_class:])
    return np.asarray(train_indices), np.asarray(val_indices)


def _texture_images(rng, lab, size=IMAGE_SIZE):
    """Class-conditional oriented-grating textures with MATCHED channel
    statistics (VERDICT r3 #2: a class signal a linear pixel map cannot
    decode, so frozen-representation evals keep their dynamic range on
    synthetic data).

    Class c sets only the texture's *spectral* identity — orientation
    ``pi * (c % 5) / 5`` and frequency band (6 vs 12 cycles for c < 5 vs
    c >= 5) — while everything first-order is class-independent:

    - 3 harmonics with iid uniform random phases per image (E[cos] = 0 ⇒
      every class has the SAME per-pixel mean), equal amplitudes across
      classes (same variance), per-image orientation jitter ±5°;
    - the same luminance texture is added to all 3 channels, plus a random
      per-image channel tint drawn identically for every class.

    Consequences (asserted by tests/test_data.py and measured by
    ``scripts/evaluation/validate_instrument.py``): per-class pixel means
    agree to ~1/sqrt(n), so a LINEAR probe on raw pixels is at chance, and
    raw-pixel k-NN is near chance (same-class images differ by 3 random
    phases); decoding requires phase-invariant spectral energy — a
    nonlinear computation a trained encoder can learn.
    """
    m = len(lab)
    yy, xx = np.meshgrid(
        np.arange(size, dtype=np.float32) / size,
        np.arange(size, dtype=np.float32) / size,
        indexing="ij",
    )

    def gratings(theta, freq, amps, n_harmonics):
        proj = (
            np.cos(theta)[:, None, None] * xx[None]
            + np.sin(theta)[:, None, None] * yy[None]
        )
        out = np.zeros((m, size, size), np.float32)
        for h, amp in zip(range(1, n_harmonics + 1), amps):
            phase = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
            out += amp * np.cos(
                2 * np.pi * freq[:, None, None] * h * proj
                + phase[:, None, None]
            )
        return out

    # class texture: orientation from c % 5, frequency band from c // 5
    theta = (np.pi * (lab % 5).astype(np.float32) / 5.0
             + rng.uniform(-np.pi / 36, np.pi / 36, m).astype(np.float32))
    freq = np.where(lab < 5, 6.0, 12.0).astype(np.float32)
    tex = gratings(theta, freq, (26.0, 15.0, 10.0), 3)
    # class-INDEPENDENT nuisance: a strong random low-frequency grating per
    # image. Without it, top-k cosine neighbours in pixel space are the
    # same-class images whose texture phases happen to align (cross-class
    # spectra are orthogonal, so even zero-mean alignment noise makes the
    # HIGHEST similarities same-class) — measured raw-pixel k-NN 100%. The
    # nuisance dominates pairwise pixel similarity identically for every
    # class, pushing raw-pixel k-NN to chance while leaving the class
    # spectra fully intact for an encoder that models them.
    n_theta = rng.uniform(0, np.pi, m).astype(np.float32)
    n_freq = rng.uniform(1.5, 3.5, m).astype(np.float32)
    nuisance = gratings(n_theta, n_freq, (55.0,), 1)
    noise = rng.integers(0, 256, (m, CHANNELS, size, size), dtype=np.uint16
                         ).astype(np.float32)
    tint = rng.normal(0.0, 12.0, (m, CHANNELS)).astype(np.float32)
    imgs = (
        0.2 * noise
        + 120.0
        + (tex + nuisance)[:, None, :, :]
        + tint[:, :, None, None]
    )
    return imgs


def write_synthetic_stl10(
    root: str | Path,
    num_train: int = 100,
    num_test: int = 50,
    num_unlabeled: int = 200,
    seed: int = 0,
    class_correlated: bool = True,
    class_signal: str = "linear",
) -> Path:
    """Fabricate a dataset in the exact STL-10 binary format.

    ``class_signal`` selects how labels show up in pixels:

    - ``"linear"`` (default): per-class mean color + class-dependent spatial
      gradient — linearly pixel-decodable; cheap and sufficient for the
      end-to-end plumbing tests, but it SATURATES frozen-representation
      evals (a random encoder probes to 100%);
    - ``"texture"``: class-conditional oriented gratings with matched
      channel statistics (see ``_texture_images``) — the representation
      -quality instrument for MAE-vs-JEPA ranking in this zero-egress
      environment.

    ``class_correlated=False`` forces pure noise regardless of signal.
    """
    if class_signal not in ("linear", "texture"):
        raise ValueError(f"unknown class_signal {class_signal!r}")
    d = Path(root) / "stl10_binary"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    def make(n: int, labeled: bool, name: str, chunk: int = 4096):
        # streamed in chunks: a 100k-image split would otherwise peak at
        # >20 GB of intermediates (int64 uniforms + fp32 mix)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        ramp = np.linspace(0, 1, IMAGE_SIZE, dtype=np.float32)
        with open(d / f"{name}_X.bin", "wb") as f:
            for lo in range(0, n, chunk):
                lab = labels[lo : lo + chunk]
                m = len(lab)
                if class_correlated and class_signal == "texture":
                    imgs = _texture_images(rng, lab)
                else:
                    imgs = rng.integers(
                        0, 256, (m, CHANNELS, IMAGE_SIZE, IMAGE_SIZE),
                        dtype=np.uint16,
                    ).astype(np.float32)
                    if class_correlated:
                        mean = np.stack(
                            [
                                50 + 20 * (lab % 5),
                                50 + 20 * ((lab + 2) % 5),
                                50 + 20 * ((lab + 4) % 5),
                            ],
                            axis=1,
                        ).astype(np.float32)  # (m, C)
                        sign = np.where(
                            lab % 2 == 0, 1.0, -1.0
                        ).astype(np.float32)
                        offset = np.where(
                            lab % 2 == 1, 40.0, 0.0
                        ).astype(np.float32)
                        grad = (
                            80.0 * sign[:, None] * ramp[None, :]
                            + offset[:, None]
                        )  # (m, W)
                        imgs = (
                            0.25 * imgs
                            + mean[:, :, None, None]
                            + grad[:, None, None, :]
                        )
                np.clip(imgs, 0, 255).astype(np.uint8).tofile(f)
        if labeled:
            (labels + 1).astype(np.uint8).tofile(d / f"{name}_y.bin")

    make(num_train, True, "train")
    make(num_test, True, "test")
    make(num_unlabeled, False, "unlabeled")
    (d / "class_names.txt").write_text("\n".join(CLASSES) + "\n")
    return d


def download_stl10(root: str | Path) -> Path:
    """Download + extract the STL-10 tarball (reference ``scripts/data.py``).

    Gated: raises a clear error in zero-egress environments.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    d = root / "stl10_binary"
    if (d / "unlabeled_X.bin").exists():
        return d
    tar_path = root / "stl10_binary.tar.gz"
    if not tar_path.exists():
        try:
            urllib.request.urlretrieve(URL, tar_path)  # noqa: S310
        except Exception as e:  # pragma: no cover - network-dependent
            raise RuntimeError(
                f"could not download STL-10 ({e}); in offline environments "
                "use write_synthetic_stl10 or provide stl10_binary/ manually"
            ) from e
    with tarfile.open(tar_path) as tf:
        tf.extractall(root)  # noqa: S202
    tar_path.unlink(missing_ok=True)
    return d
