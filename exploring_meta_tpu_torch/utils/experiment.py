"""Experiment harness: run dirs, metric logs, checkpoints (port of
``exploring_meta_tpu/utils/experiment.py``, less its compile cache, orbax,
wandb and asynchronous writes).

The run directory keeps the reference's artifact contract::

    <path>/<algo>_<dataset>_<date>_<seed>_<rand>/
        logger.json        config + metadata ('elapsed_time', 'final_eval',
                           'manually_stopped' / 'diverged')
        metrics.json       {metric_name: [values...]}
        model.npz          final params (flat {slash/path: array})
        model_checkpoints/model_<iter>.npz

Keys are slash paths (``base/0/conv/w``, ``mean/0/w``) exactly as the JAX
package writes them, and arrays keep the JAX layout, so a ``model.npz``
written by either package loads in the other.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re

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


def list_checkpoints(run_dir: str) -> list:
    """Numerically sorted ``[(step, path)]`` of
    ``model_checkpoints/model_<step>.npz`` under ``run_dir`` (a
    lexicographic sort would put model_10 before model_2)."""
    out = []
    for path in glob.glob(os.path.join(run_dir, "model_checkpoints",
                                       "model_*.npz")):
        m = re.search(r"model_(\d+)\.npz$", path)
        if m:
            out.append((int(m.group(1)), path))
    return sorted(out)


class DivergenceError(RuntimeError):
    """Raised by the watchdog when a logged ``*loss`` metric goes
    non-finite; trainers catch it beside KeyboardInterrupt and finish
    gracefully (mark the logger, save, evaluate)."""


class Experiment:
    """Logger/checkpointer each trainer inherits (reference Experiment)."""

    def __init__(self, algo: str, dataset: str, params: dict,
                 path: str = "results/"):
        params = dict(params)
        params["algo"] = algo
        params["dataset"] = dataset
        params.setdefault("seed", 42)
        self.params = params
        self.nan_guard = bool(params.get("nan_guard", True))
        rng = np.random.default_rng()
        self.logger = {
            "config": self.params,
            "date": datetime.datetime.now().strftime("%d_%m_%Hh%M"),
            "model_id": f"{params['seed']}_{rng.integers(1, 9999)}",
        }
        self.metrics: dict = {}
        self.model_path = os.path.join(
            path, f"{algo}_{dataset}_{self.logger['date']}_"
                  f"{self.logger['model_id']}")
        os.makedirs(os.path.join(self.model_path, "model_checkpoints"))

    def log_metrics(self, metrics: dict) -> None:
        """Append each value to its metric's list; raise
        :class:`DivergenceError` after appending a non-finite ``*loss``
        (when ``nan_guard`` is on), so metrics.json keeps the evidence."""
        diverged = None
        for key, value in metrics.items():
            scalar = (float(value)
                      if np.isscalar(value) or hasattr(value, "item")
                      else value)
            self.metrics.setdefault(key, []).append(scalar)
            if (self.nan_guard and "loss" in key
                    and isinstance(scalar, float) and not np.isfinite(scalar)):
                diverged = (key, scalar)
        if diverged is not None:
            raise DivergenceError(
                f"{diverged[0]} = {diverged[1]} at logged step "
                f"{len(self.metrics[diverged[0]]) - 1}")

    def mark_stopped(self, exc: BaseException,
                     iteration: int | None = None) -> None:
        """KeyboardInterrupt / DivergenceError bookkeeping of the graceful
        finish; ``iteration`` truncates the recorded ``num_iterations``."""
        if isinstance(exc, DivergenceError):
            print(f"\nTraining loss diverged ({exc}) - stopping, saving "
                  "state & evaluating...\n")
            self.logger["diverged"] = str(exc)
        else:
            print("\nManually stopped training! Start evaluation & "
                  "saving...\n")
            self.logger["manually_stopped"] = True
        if iteration is not None:
            self.params["num_iterations"] = iteration

    def log_model(self, params, name: str = "model") -> None:
        """Architecture summary, printed and written to ``<name>.summary``."""
        flat = flatten_params(params)
        lines = [f"{k}: shape={v.shape} params={v.size}"
                 for k, v in flat.items()]
        lines.append(f"TOTAL PARAMS: {sum(v.size for v in flat.values())}")
        info = "\n".join(lines)
        print(info)
        with open(os.path.join(self.model_path, f"{name}.summary"), "w") as f:
            f.write(info)

    def save_logs_to_file(self) -> None:
        """metrics.json and logger.json as strict JSON: a non-finite float
        (a diverged run's evidence) is written as null."""
        def finite(v):
            if isinstance(v, float) and not np.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: finite(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [finite(x) for x in v]
            return v

        with open(os.path.join(self.model_path, "metrics.json"), "w") as f:
            json.dump(finite(self.metrics), f)
        with open(os.path.join(self.model_path, "logger.json"), "w") as f:
            json.dump(finite(self.logger), f, sort_keys=True, indent=4,
                      default=str)

    def save_model(self, params, name: str = "model") -> None:
        np.savez(os.path.join(self.model_path, f"{name}.npz"),
                 **flatten_params(params))

    def save_model_checkpoint(self, params, iteration: int,
                              name: str = "model") -> None:
        """``model_checkpoints/<name>_<iteration>.npz``: the params and
        ``__iteration__``, under the JAX package's key names."""
        flat = flatten_params(params)
        flat["__iteration__"] = np.asarray(int(iteration))
        np.savez(os.path.join(self.model_path, "model_checkpoints",
                              f"{name}_{iteration}.npz"), **flat)
