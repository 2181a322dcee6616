"""Packed few-shot datasets on the device (port of
``exploring_meta_tpu/tasks/datasets.py``, Omniglot part).

A split is one uint8 tensor ``[n_classes, n_per_class, H, W, C]`` on the
device. Real Omniglot is read from a packed ``omniglot.npz`` when one is
present (``scripts/pack_datasets.py`` writes it; nothing is downloaded);
otherwise a deterministic synthetic dataset of the same shape is made by
the same numpy code as the JAX package, so both packages see the same
bytes for the same seed.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from exploring_meta_tpu_torch.device import resolve_device

DATA_DIR = os.environ.get("EXPLORING_META_TPU_DATA",
                          os.path.expanduser("~/data/exploring_meta_tpu"))


class PackedDataset(NamedTuple):
    """Device-resident episodic dataset for one split."""
    images: torch.Tensor     # [n_classes, n_per_class, H, W, C] uint8
    name: str
    invert: bool             # omniglot applies 1 - x after /255
    rotations: bool          # omniglot augments with random class rotations

    @property
    def n_classes(self) -> int:
        return self.images.shape[0]

    @property
    def n_per_class(self) -> int:
        return self.images.shape[1]


def _synthetic_classes(seed: int, n_classes: int, n_per_class: int,
                       h: int, w: int, c: int) -> np.ndarray:
    """Separable synthetic classes: smooth class-specific pattern + noise
    (a copy of the JAX package's numpy generator)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.empty((n_classes, n_per_class, h, w, c), dtype=np.uint8)
    for cls in range(n_classes):
        freq = rng.uniform(0.15, 0.9, size=(4, c))
        phase = rng.uniform(0, 2 * np.pi, size=(4, c))
        base = np.zeros((h, w, c), dtype=np.float32)
        for k in range(4):
            for ch in range(c):
                base[..., ch] += np.sin(freq[k, ch] * (xx + yy * (k % 2)) + phase[k, ch])
        base = (base - base.min()) / (np.ptp(base) + 1e-6)
        noise = rng.normal(0, 0.12, size=(n_per_class, h, w, c)).astype(np.float32)
        samples = np.clip(base[None] + noise, 0, 1)
        imgs[cls] = (samples * 255).astype(np.uint8)
    return imgs


def _load_packed(path: str) -> np.ndarray | None:
    if os.path.exists(path):
        with np.load(path) as z:
            return z["images"]
    return None


def load_omniglot(seed: int = 42, synthetic: bool | None = None,
                  synthetic_classes: int = 160, synthetic_per_class: int = 20,
                  device=None):
    """-> (train, valid, test) PackedDatasets with the 1100/100/423
    shuffled-class split (scaled proportionally when synthetic).

    ``synthetic``: True -> synthetic; None -> the packed file if present,
    else synthetic; False -> the packed file is required."""
    dev = resolve_device(device)
    path = os.path.join(DATA_DIR, "omniglot.npz")
    packed = None if synthetic else _load_packed(path)
    if packed is None and synthetic is False:
        raise FileNotFoundError(
            f"synthetic=False but no packed dataset at {path}; run "
            "scripts/pack_datasets.py (or pass synthetic=None to allow the "
            "synthetic fallback)")
    if packed is None:
        n = synthetic_classes
        packed = _synthetic_classes(seed, n, synthetic_per_class, 28, 28, 1)
        splits = (int(n * 1100 / 1623), int(n * 1200 / 1623))
    else:
        if packed.shape[0] != 1623:
            raise ValueError(
                f"packed omniglot has {packed.shape[0]} classes, expected "
                "1623 (full FullOmniglot)")
        splits = (1100, 1200)

    order = np.random.default_rng(seed).permutation(packed.shape[0])

    def mk(cls_ids):
        return PackedDataset(
            images=torch.from_numpy(np.ascontiguousarray(packed[cls_ids])).to(dev),
            name="omni", invert=True, rotations=True)

    return (mk(order[:splits[0]]), mk(order[splits[0]:splits[1]]),
            mk(order[splits[1]:]))
