"""Carry params between the JAX package and the port.

Both packages keep params in the same nested dict/list and the same
layout (HWIO conv weights, ``[in, out]`` linear weights), so the bridge
is a keyed copy plus a shape check. Arrays cross as numpy; this module
imports neither JAX nor the JAX package (a JAX array converts through
``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import torch

from exploring_meta_tpu_torch.utils.tree import (
    tree_from_items, tree_items, tree_map,
)


def params_from_jax(src, device, dtype=torch.float32, template=None,
                    seeds: int | None = None):
    """JAX params -> torch params on ``device``.

    ``src`` is a params tree (dicts/lists of JAX or numpy arrays) or a flat
    ``{slash/path: array}`` dict as ``flatten_params`` writes it. With a
    ``template`` (e.g. ``init_cnn4(..., device="cpu")``) the keys and
    shapes must match it exactly; with ``seeds`` too, ``src`` is a stacked
    tree (JAX's ``stack_seed_states``: a leading seed axis on every leaf)
    and each shape must be the template's behind ``seeds``."""
    # a flat dict's keys are already slash paths, so both forms flatten
    # to the same items
    items = [(k, np.array(v)) for k, v in tree_items(src)]
    if template is not None:
        lead = () if seeds is None else (seeds,)
        want = {k: lead + tuple(v.shape) for k, v in tree_items(template)}
        got = {k: tuple(v.shape) for k, v in items}
        if want != got:
            raise ValueError(f"params do not match the template: "
                             f"{sorted(set(want.items()) ^ set(got.items()))}")
    return tree_from_items(
        (k, torch.as_tensor(v, dtype=dtype, device=device)) for k, v in items)


def params_to_numpy(params):
    """Torch params -> the same tree of float32 numpy arrays (a stacked
    ``[S, ...]`` tree stays stacked, as JAX's ``vmap_seeds`` returns it)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)

