"""Packed few-shot datasets on the device (port of
``exploring_meta_tpu/tasks/datasets.py``).

A split is one uint8 tensor ``[n_classes, n_per_class, H, W, C]`` on the
device. Real Omniglot and Mini-ImageNet are read from packed ``.npz``
files when present (``tasks/pack.py`` writes them, as the JAX package's
``emt-pack-datasets`` does; nothing is downloaded); otherwise a deterministic synthetic dataset of the same
shape is made by the same numpy code as the JAX package, so both
packages see the same bytes for the same seed.
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


def _resolve_packed(synthetic: bool | None, path: str) -> np.ndarray | None:
    """``synthetic``: True -> None (synthetic); None -> the packed file if
    present, else None; False -> the packed file is required."""
    if synthetic:
        return None
    packed = _load_packed(path)
    if packed is None and synthetic is False:
        raise FileNotFoundError(
            f"synthetic=False but no packed dataset at {path}; run "
            "scripts/pack_datasets.py (or pass synthetic=None to allow the "
            "synthetic fallback)")
    return packed


def _on(dev, packed: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(packed)).to(dev)


def load_omniglot(seed: int = 42, synthetic: bool | None = None,
                  synthetic_classes: int = 160, synthetic_per_class: int = 20,
                  device=None):
    """-> (train, valid, test) PackedDatasets with the 1100/100/423
    shuffled-class split (scaled proportionally when synthetic)."""
    dev = resolve_device(device)
    packed = _resolve_packed(synthetic, os.path.join(DATA_DIR, "omniglot.npz"))
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
        return PackedDataset(images=_on(dev, packed[cls_ids]), name="omni",
                             invert=True, rotations=True)

    return (mk(order[:splits[0]]), mk(order[splits[0]:splits[1]]),
            mk(order[splits[1]:]))


def load_mini_imagenet(seed: int = 42, synthetic: bool | None = None,
                       synthetic_per_class: int = 64, device=None):
    """-> (train, valid, test) PackedDatasets; the 64/16/20 class splits
    are fixed by the dataset, not reshuffled. The three splits resolve
    together: a partial pack raises rather than mixing real and synthetic
    splits."""
    dev = resolve_device(device)
    sizes = {"train": 64, "validation": 16, "test": 20}
    paths = {m: os.path.join(DATA_DIR, f"mini_imagenet_{m}.npz")
             for m in sizes}
    if synthetic is not True:
        present = {m: os.path.exists(p) for m, p in paths.items()}
        if any(present.values()) and not all(present.values()):
            missing = [paths[m] for m, ok in present.items() if not ok]
            raise ValueError(
                f"partially packed mini-ImageNet: missing {missing}; re-run "
                "scripts/pack_datasets.py for every split, or use "
                "synthetic=True")
    out = []
    for i, (mode, n_cls) in enumerate(sizes.items()):
        packed = _resolve_packed(synthetic, paths[mode])
        if packed is None:
            packed = _synthetic_classes(seed + i, n_cls, synthetic_per_class,
                                        84, 84, 3)
        out.append(PackedDataset(images=_on(dev, packed), name="min",
                                 invert=False, rotations=False))
    return tuple(out)


def get_dataset(name: str, seed: int = 42, synthetic: bool | None = None,
                synth_classes: int = 0, synth_per_class: int = 0,
                device=None):
    """Name-routed factory: ``omni`` | ``min`` (and their long names).

    ``synth_classes`` / ``synth_per_class`` (0: the small defaults) size
    the synthetic fallback; the real shapes are ``omni`` 1623 classes x 20
    and ``min`` 64/16/20 classes x 600."""
    kw = {"synthetic_per_class": synth_per_class} if synth_per_class else {}
    if name in ("omni", "omniglot"):
        if synth_classes:
            kw["synthetic_classes"] = synth_classes
        return load_omniglot(seed=seed, synthetic=synthetic, device=device,
                             **kw)
    if name in ("min", "mini-imagenet", "mini_imagenet"):
        if synth_classes:
            raise ValueError("mini-ImageNet class counts are fixed by the "
                             "dataset (64/16/20); only synth_per_class is "
                             "tunable (real shape: 600)")
        return load_mini_imagenet(seed=seed, synthetic=synthetic,
                                  device=device, **kw)
    raise ValueError(f"unknown dataset {name!r}")
