"""Offline vision evaluation of a run directory (port of
``exploring_meta_tpu/analysis/eval_vision.py``; reference
``misc_scripts/eval_vision.py``): given a run directory (the artifact
contract of ``utils/experiment.py``, written by either package), reload
the config from ``logger.json``, rebuild the model and run

- a per-checkpoint meta-test accuracy sweep -> ``ckpnt_results.json``;
- the final meta-test accuracy over ``n_eval_batches`` meta-batches;
- optionally the CL and representation-change experiments, and the CCA
  of consecutive checkpoints -> ``cl_exp/``, ``rep_exp/``,
  ``cca_through_time.json``;
- everything -> ``eval_results.json``.

It runs on the card unless ``device="cpu"``; the CNN4-Omniglot base runs
on the fused CNN4 kernels under the default ``conv_impl``. Each section
is a module-level function that :func:`run` looks up when it calls it.
"""

from __future__ import annotations

import json
import os

import torch

from exploring_meta_tpu_torch.adapt.maml import make_meta_eval
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.analysis.cl import run_cl_exp
from exploring_meta_tpu_torch.analysis.rc import (
    measure_change_through_time, run_rep_exp,
)
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.models import cnn4
from exploring_meta_tpu_torch.tasks.datasets import get_dataset
from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
from exploring_meta_tpu_torch.utils.experiment import (
    list_checkpoints, load_params,
)


def _spec_from_config(config: dict, anil: bool) -> cnn4.CNN4Spec:
    ways = config["ways"]
    if config["dataset"] == "omni":
        return (cnn4.anil_omniglot_spec(ways) if anil
                else cnn4.omniglot_spec(ways))
    return (cnn4.anil_mini_imagenet_spec(ways) if anil
            else cnn4.mini_imagenet_spec(ways))


def _meta_batch(gen, test_ds, config: dict, n: int | None = None):
    return sample_task_batch(gen, test_ds, config["ways"], config["shots"],
                             n or config["meta_batch_size"])


def checkpoint_sweep(meta_eval, template, base_path: str, test_ds,
                     config: dict, gen: torch.Generator) -> dict:
    """Meta-test accuracy of every checkpoint on one meta-batch each
    (reference ``eval_vision.py:79-88``) -> ``{step: accuracy}``."""
    return {step: float(meta_eval(load_params(path, template),
                                  *_meta_batch(gen, test_ds, config))
                        ["metric"])
            for step, path in list_checkpoints(base_path)}


def meta_test_accuracy(meta_eval, params, test_ds, config: dict,
                       gen: torch.Generator, n_eval_batches: int) -> float:
    """Mean meta-test accuracy over ``n_eval_batches`` meta-batches."""
    accs = [meta_eval(params, *_meta_batch(gen, test_ds, config))["metric"]
            for _ in range(n_eval_batches)]
    accs = torch.stack(accs).tolist()       # one copy to the host
    return sum(accs) / len(accs)


def run(base_path: str, n_eval_batches: int = 20, run_cl: bool = True,
        run_rc: bool = True, cl_params: dict | None = None,
        rep_params: dict | None = None, synthetic: bool | None = None,
        device=None) -> dict:
    dev = resolve_device(device)
    with open(os.path.join(base_path, "logger.json")) as f:
        config = json.load(f)["config"]
    anil = config["algo"].startswith("anil")
    spec = _spec_from_config(config, anil)

    template = cnn4.init_cnn4(torch.Generator(device=dev).manual_seed(0),
                              spec, device=dev)
    params = load_params(os.path.join(base_path, "model.npz"), template)

    _, _, test_ds = get_dataset(
        config["dataset"], seed=config["seed"],
        synthetic=synthetic if synthetic is not None
        else config.get("synthetic") or None, device=dev)

    fast_adapt = make_vision_fast_adapt(
        spec, inner_lr=config["inner_lr"], adapt_steps=config["adapt_steps"],
        shots=config["shots"], ways=config["ways"], anil=anil)
    meta_eval = make_meta_eval(fast_adapt)
    gen = torch.Generator(device=dev).manual_seed(config["seed"] + 1)

    ckpt_results = checkpoint_sweep(meta_eval, template, base_path, test_ds,
                                    config, gen)
    with open(os.path.join(base_path, "ckpnt_results.json"), "w") as f:
        json.dump(ckpt_results, f, sort_keys=True, indent=4)

    test_acc = meta_test_accuracy(meta_eval, params, test_ds, config, gen,
                                  n_eval_batches)
    print("Meta Test Accuracy", test_acc)
    out = {"test_acc": test_acc, "ckpnt_results": ckpt_results}

    apply_fn = lambda p, x: cnn4.cnn4_apply(p, spec, x)
    if run_cl:
        anil_kwargs = {}
        if anil:  # head-only adaptation on frozen features
            anil_kwargs = dict(
                features_fn=lambda p, x: cnn4.cnn4_features(p, spec, x),
                head_apply=cnn4.cnn4_head_apply)
        _, out["cl_res"] = run_cl_exp(base_path, apply_fn, params, test_ds,
                                      config["ways"], config["shots"], gen,
                                      cl_params=cl_params, **anil_kwargs)
    if run_rc:
        rep_fn = lambda p, x, layer: cnn4.get_rep_layer(p, spec, x, layer)
        out["rep_res"] = run_rep_exp(base_path, apply_fn, rep_fn, params,
                                     test_ds, config["ways"],
                                     config["shots"], gen,
                                     rep_params=rep_params)
        # representation drift across training checkpoints (reference
        # rc_rl.py:295-353) on one task's images
        ckpt_paths = [path for _, path in list_checkpoints(base_path)]
        if len(ckpt_paths) >= 2:
            probe = _meta_batch(gen, test_ds, config, 1)[0][0]
            out["cca_through_time"] = measure_change_through_time(
                base_path, [load_params(p, template) for p in ckpt_paths],
                lambda p, x: cnn4.cnn4_features(p, spec, x), probe)

    with open(os.path.join(base_path, "eval_results.json"), "w") as f:
        json.dump(out, f, sort_keys=True, indent=4, default=str)
    return out
