"""One-time host-side packing of real datasets into the arrays the sampler
gathers from (port of ``exploring_meta_tpu/tasks/pack.py``, the JAX
package's ``emt-pack-datasets``).

It converts the original downloads into packed ``[n_classes, n_per_class,
H, W, C]`` uint8 arrays, which ``tasks/datasets.py`` loads onto the device
(the replacement for the reference's per-sample PIL pipeline,
``utils/data_pre.py:16-35``):

- Omniglot: the images_background + images_evaluation directories (1623
  character classes x 20 samples), resized to 28x28 with LANCZOS. The
  images are stored raw: the invert (1 - x) happens on the device.
- Mini-ImageNet: the standard ``mini-imagenet-cache-{split}.pkl`` pickles
  (84x84x3, 600 images a class).

Pillow is imported inside :func:`pack_omniglot` only. The files are the
JAX package's, byte for byte, so either package reads them.

CLI: ``python -m exploring_meta_tpu_torch.cli pack_datasets``.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np


def pack_omniglot(src: str, out: str) -> None:
    from PIL import Image

    class_dirs = []
    for part in ("images_background", "images_evaluation"):
        base = os.path.join(src, part)
        class_dirs += sorted(glob.glob(os.path.join(base, "*", "character*")))
    if not class_dirs:
        raise SystemExit(f"no Omniglot class directories under {src}")
    print(f"{len(class_dirs)} classes")

    n_per = 20
    images = np.zeros((len(class_dirs), n_per, 28, 28, 1), np.uint8)
    for ci, cdir in enumerate(class_dirs):
        files = sorted(glob.glob(os.path.join(cdir, "*.png")))[:n_per]
        if len(files) < n_per:
            # never zero-fill: all-black rows would be packed as real
            # samples and corrupt every run that reads them
            raise SystemExit(
                f"{cdir}: {len(files)} PNGs, expected {n_per}: the "
                "download is incomplete")
        for si, fp in enumerate(files):
            img = Image.open(fp).convert("L").resize((28, 28),
                                                     Image.LANCZOS)
            images[ci, si, :, :, 0] = np.asarray(img, np.uint8)
    os.makedirs(out, exist_ok=True)
    np.savez_compressed(os.path.join(out, "omniglot.npz"), images=images)
    print(f"wrote {out}/omniglot.npz {images.shape}")


def pack_mini_imagenet(src: str, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    for mode in ("train", "validation", "test"):
        # l2l cache pickles: {"image_data": [N,84,84,3], "class_dict": {...}}
        stem = "val" if mode == "validation" else mode
        for cand in (f"mini-imagenet-cache-{mode}.pkl",
                     f"mini-imagenet-cache-{stem}.pkl"):
            path = os.path.join(src, cand)
            if os.path.exists(path):
                break
        else:
            raise SystemExit(
                f"missing mini-imagenet pickle for {mode} in {src}")
        with open(path, "rb") as f:
            data = pickle.load(f)
        img = np.asarray(data["image_data"], np.uint8)
        classes = sorted(data["class_dict"].keys())
        n_per = min(len(v) for v in data["class_dict"].values())
        packed = np.stack([img[data["class_dict"][c][:n_per]]
                           for c in classes])
        np.savez_compressed(
            os.path.join(out, f"mini_imagenet_{mode}.npz"), images=packed)
        print(f"wrote mini_imagenet_{mode}.npz {packed.shape}")
