"""Params <-> flat ``.npz`` contract (port of ``flatten_params``,
``unflatten_into`` and ``load_params`` from
``exploring_meta_tpu/utils/experiment.py``).

Keys are slash paths (``base/0/conv/w``, ``head/b``) exactly as the JAX
package writes them, and arrays keep the JAX layout, so a ``model.npz``
written by the JAX trainers loads here as it is, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from exploring_meta_tpu_torch.utils.tree import tree_from_items, tree_items


def flatten_params(tree, prefix: str = "") -> dict:
    """Params tree -> flat ``{slash/path: np.ndarray}`` (npz-serializable)."""
    return {prefix + key: leaf.detach().cpu().numpy()
            for key, leaf in tree_items(tree)}


def unflatten_into(tree, flat: dict, prefix: str = ""):
    """Inverse of :func:`flatten_params` given a structural template: each
    leaf takes the template leaf's dtype and device, and must match its
    shape."""
    def rebuild(key, leaf):
        arr = flat[prefix + key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{prefix + key}: shape {tuple(arr.shape)} != "
                             f"{tuple(leaf.shape)}")
        return torch.as_tensor(np.asarray(arr), dtype=leaf.dtype,
                               device=leaf.device)

    return tree_from_items((key, rebuild(key, leaf))
                           for key, leaf in tree_items(tree))


def load_params(path: str, template):
    """Load a ``model.npz`` / checkpoint into the structure of ``template``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_into(template, flat)
