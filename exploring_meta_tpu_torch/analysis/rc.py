"""Representation-change probes: CCA / CKA before vs after adaptation
(port of ``exploring_meta_tpu/analysis/rc.py``; reference
``misc_scripts/rc_vision.py`` / ``rc_rl.py``): for each sampled task,
adapt a fresh copy of the model, take layer activations of the initial
and the adapted model on the same inputs, and measure their similarity
with SVCCA, optionally linear / kernel CKA. Results are ``{layer: [one
similarity per task]}`` dicts written as JSON, plus a deterministic
sanity check (``rc_rl.py:34-80``): identical params on identical inputs
must give bit-identical representations.

Activations stay on their device: the CCA covariance and the CKA
products run there (``ops/cca.py``, ``ops/cka.py``).
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd, per_task
from exploring_meta_tpu_torch.ops.cca import get_cca_similarity
from exploring_meta_tpu_torch.ops.cka import get_kernel_CKA, get_linear_CKA
from exploring_meta_tpu_torch.ops.losses import cross_entropy
from exploring_meta_tpu_torch.rl.adapt_rl import single_adapt_step
from exploring_meta_tpu_torch.tasks.sampler import (
    sample_task_batch, split_support_query,
)
from exploring_meta_tpu_torch.utils.plotter import (
    plot_sim_across_layers_average,
)
from exploring_meta_tpu_torch.utils.tree import tree_map


def _rows(x) -> torch.Tensor:
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.detach().reshape(x.shape[0], -1)


def sanity_check(rep_fn: Callable, params, inputs) -> None:
    """Deterministic-representation check (reference ``rc_rl.py:34-80``):
    two calls must agree bit for bit."""
    with torch.no_grad():
        r1 = rep_fn(params, inputs).cpu().numpy()
        r2 = rep_fn(params, inputs).cpu().numpy()
    if not np.array_equal(r1, r2):
        raise AssertionError("representations are not deterministic")


def real_states(traj) -> torch.Tensor:
    """Flat states of one task's trajectory ``[T, E, ...]`` without the
    post-termination filler rows: the reference walks only real episode
    states (``rc_rl.py:246-283``)."""
    return traj.flat(traj.state)[traj.flat(traj.valid) > 0]


def _similarities(init_rep, adapted_rep, compare: tuple) -> dict:
    """Similarity measures of ``[N, ...]`` activations (flattened to ``[N,
    features]``)."""
    out = {}
    a, b = _rows(adapted_rep), _rows(init_rep)
    if "cca" in compare:
        # CCA wants the smaller axis first (conv reps as (batch, C*H*W),
        # MLP reps as (features, N), as the reference feeds them)
        if a.shape[0] == a.shape[1]:
            # square activations satisfy neither orientation: drop one
            # datapoint (for CKA too, as in JAX)
            a, b = a[:-1], b[:-1]
        ca, cb = (a, b) if a.shape[0] < a.shape[1] else (a.T, b.T)
        out["cca"] = get_cca_similarity(ca, cb, epsilon=1e-10)[1]
    if "cka_linear" in compare:
        out["cka_linear"] = float(get_linear_CKA(a, b))
    if "cka_kernel" in compare:
        out["cka_kernel"] = float(get_kernel_CKA(a, b))
    return out


def _dump(path: str, obj, **kw) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=True, indent=4, **kw)


def rep_similarities(apply_fn: Callable, rep_fn: Callable, params, data,
                     labels, ways: int, shots: int, rep_params: dict,
                     compare: tuple = ("cca",)) -> dict:
    """Vision probes of a task pool ``(data [n, N, ...], labels [n, N])``:
    per task, ``inner_sgd`` on its support set, then each layer's
    activations of the initial and adapted model on its query images ->
    ``{metric: {str(layer): [one value per task]}}``."""
    layers = rep_params["layers"]
    results = {m: {str(l): [] for l in layers} for m in compare}

    def loss_fn(p, batch):
        return cross_entropy(apply_fn(p, batch[0]), batch[1])

    (xs, ys), (xq, _) = split_support_query(data, labels, shots, ways)
    with torch.no_grad():
        for i in range(data.shape[0]):
            adapted = inner_sgd(loss_fn, params, (xs[i], ys[i]),
                                rep_params["inner_lr"],
                                rep_params["adapt_steps"])
            for layer in layers:
                sims = _similarities(rep_fn(params, xq[i], layer),
                                     rep_fn(adapted, xq[i], layer), compare)
                for metric, value in sims.items():
                    results[metric][str(layer)].append(float(value))
    return results


def run_rep_exp(path, apply_fn: Callable, rep_fn: Callable, params, dataset,
                ways: int, shots: int, gen: torch.Generator,
                rep_params: dict | None = None,
                compare: tuple = ("cca",)) -> dict:
    """Vision representation-change experiment -> ``{"cca": {layer:
    [per-task similarities]}, ...}``, written to ``<path>/rep_exp/``.
    ``apply_fn(params, x) -> logits`` (the adaptation loss); ``rep_fn(params,
    x, layer)`` the per-layer tap (``models/cnn4.py:get_rep_layer``)."""
    rep_params = dict(rep_params or {"adapt_steps": 1, "inner_lr": 0.1,
                                     "n_tasks": 5, "layers": [4]})
    rep_path = os.path.join(path, "rep_exp")
    os.makedirs(rep_path, exist_ok=True)
    data, labels = sample_task_batch(gen, dataset, ways, shots,
                                     rep_params["n_tasks"])
    results = rep_similarities(apply_fn, rep_fn, params, data, labels, ways,
                               shots, rep_params, compare)
    for metric, per_layer in results.items():
        _dump(os.path.join(rep_path, f"{metric}_results.json"), per_layer)
    return results


def _per_state_similarity(rep_a, rep_b, max_states: int = 50):
    """Per-state similarity of two models' representation vectors:
    |Pearson correlation| of the two vectors, mean and stdev (ddof 1) over
    the first ``max_states`` states (the reference's
    ``episode_mean_var`` / ``calculate_rep_change``, ``rc_rl.py:246-283``,
    whose per-state "CCA" of a (1, features) matrix reduces to this).
    Host float64."""
    a = np.asarray(_rows(rep_a)[:max_states].cpu(), dtype=np.float64)
    b = np.asarray(_rows(rep_b)[:max_states].cpu(), dtype=np.float64)
    sims = []
    for ra, rb in zip(a, b):
        ra = ra - ra.mean()
        rb = rb - rb.mean()
        denom = np.linalg.norm(ra) * np.linalg.norm(rb)
        if denom > 0:
            sims.append(abs(float(ra @ rb / denom)))
        # a constant (dead) representation carries no similarity: skip it
        # rather than report a 1.0 that inflates the mean
    if not sims:
        return 1.0, 0.0
    return float(np.mean(sims)), float(np.std(sims, ddof=1) if len(sims) > 1
                                       else 0.0)


def _task(tree, i: int = 0):
    """Task ``i`` of per-task params or of a task-batch trajectory."""
    if hasattr(tree, "map"):
        return tree.map(lambda x: x[i])
    return tree_map(lambda x: x[i], tree)


def run_rep_rl_exp(path, policy, params, env, rollout_fn: Callable, cfg,
                   gen: torch.Generator, rep_params: dict | None = None,
                   compare: tuple = ("cca",), algo: str = "trpo",
                   eval_each_task: bool = False,
                   grouped_roll_factory: Callable | None = None) -> dict:
    """RL representation-change experiment (reference ``rc_rl.py:83-221``).
    Per task, adapt step by step (``single_adapt_step``: vpg / ppo / trpo,
    first order), tracking

    - across steps: per-state similarity (mean, stdev) of the initial and
      the post-step model, and of consecutive models, on the support
      states;
    - across layers: CCA of the initial and the fully adapted model per
      layer on the query states. The reference clones the adapted model
      into its "before" model first (``rc_rl.py:167,170``) and so
      compares it with itself; JAX, and this port, keep the
      initial-vs-adapted comparison;
    - the success rate before and after adaptation;

    then averages the layer changes over tasks and writes
    ``rep_params.json``, ``<metric>_rl_results.json``, ``rep_extra.json``
    and the layer-average plot (``layer_changes_average.png``, where
    matplotlib is installed).

    ``eval_each_task`` probes 3 trials of every distinct task id
    (Meta-World; reference ``rep_params['eval_each_task']``). A
    ``grouped_roll_factory`` (host envs, ``envs/host.py``) collects all
    tasks' rollouts in lockstep, ``adapt_steps + 1`` grouped rollouts in
    all, with the same probes and artifacts (lists stay task-major)."""
    from exploring_meta_tpu_torch.rl.evaluate import sample_3_from_each_task

    # the reference eval config's layers (eval_rl.py:77), module-counted
    # (models/policies.py get_representation): 2 / 4 Linear outputs, -1
    # the pre-head tap
    rep_params = dict(rep_params or {"n_tasks": 5, "layers": [2, 4, -1]})
    layers = rep_params["layers"]
    adapt_steps = rep_params.get("adapt_steps", cfg.adapt_steps)
    rep_path = os.path.join(path, "rep_exp")
    os.makedirs(rep_path, exist_ok=True)

    tasks = (sample_3_from_each_task(env, gen) if eval_each_task
             else env.sample_tasks(gen, rep_params["n_tasks"]))
    n = len(tasks)
    rep = policy.get_representation
    results = {m: {str(l): [] for l in layers} for m in compare}
    across_steps = {"init_mean": [], "init_var": [],
                    "adapt_mean": [], "adapt_var": []}
    performance = []

    def probe_step(support, before, after) -> tuple:
        """One task's across-steps probes on its support states."""
        states = real_states(support)
        rep_after = rep(after, states)
        return (*_per_state_similarity(rep(params, states), rep_after),
                *_per_state_similarity(rep(before, states), rep_after))

    def probe_layers(query, adapted) -> None:
        """One task's across-layers probes on its query states."""
        states = real_states(query)
        for layer in layers:
            sims = _similarities(rep(params, states, layer),
                                 rep(adapted, states, layer), compare)
            for metric, value in sims.items():
                results[metric][str(layer)].append(float(value))

    def success(support, i: int) -> float:
        return float(_task(support, i).episode_successes().mean())

    with torch.no_grad():
        if grouped_roll_factory is not None:
            grouped = grouped_roll_factory(n)
            cur = per_task(params, n)
            bufs = [[] for _ in range(n)]
            suc = [[0.0, 0.0] for _ in range(n)]
            for step in range(adapt_steps):
                support = grouped(cur, tasks, gen)
                after = single_adapt_step(algo, policy, cur, support, cfg)
                for i in range(n):
                    suc[i][1] = success(support, i)
                    if step == 0:
                        suc[i][0] = suc[i][1]
                    bufs[i].append(probe_step(_task(support, i),
                                              _task(cur, i), _task(after, i)))
                cur = after
            query = grouped(cur, tasks, gen)
            sanity_check(rep, params, real_states(_task(query)))
            for i in range(n):  # task-major, as the per-task loop
                for probes in bufs[i]:
                    for k, v in zip(across_steps, probes):
                        across_steps[k].append(v)
                performance.append({"success_before": suc[i][0],
                                    "success_after": suc[i][1]})
                probe_layers(_task(query, i), _task(cur, i))
        else:
            for i in range(n):
                task = tasks[i:i + 1]
                before = per_task(params, 1)
                suc_before = suc_after = 0.0
                for step in range(adapt_steps):
                    support = rollout_fn(before, task, gen)
                    after = single_adapt_step(algo, policy, before, support,
                                              cfg)
                    suc_after = success(support, 0)
                    if step == 0:
                        suc_before = suc_after
                    for k, v in zip(across_steps, probe_step(
                            _task(support), _task(before), _task(after))):
                        across_steps[k].append(v)
                    before = after
                performance.append({"success_before": suc_before,
                                    "success_after": suc_after})
                query = _task(rollout_fn(before, task, gen))
                sanity_check(rep, params, real_states(query))
                probe_layers(query, _task(before))

    # the layer change averaged over tasks (reference av_layer_changes)
    av_mean, av_std = {}, {}
    if "cca" in compare:
        for layer, values in results["cca"].items():
            av_mean[layer] = float(np.mean(values))
            av_std[layer] = float(np.std(values, ddof=1)
                                  if len(values) > 1 else 0.0)
        plot_sim_across_layers_average(
            av_mean, av_std, title="Before / After adaptation",
            save_path=os.path.join(rep_path, "layer_changes_average.png"))

    for metric, per_layer in results.items():
        _dump(os.path.join(rep_path, f"{metric}_rl_results.json"), per_layer)
    _dump(os.path.join(rep_path, "rep_params.json"),
          {**rep_params, "algo": algo, "eval_each_task": eval_each_task},
          default=str)
    _dump(os.path.join(rep_path, "rep_extra.json"),
          {"across_steps": across_steps, "av_layer_changes_mean": av_mean,
           "av_layer_changes_std": av_std, "performance": performance})
    results["across_steps"] = across_steps
    results["av_layer_changes"] = {"mean": av_mean, "std": av_std}
    return results


def measure_change_through_time(path, checkpoint_params: list,
                                rep_fn: Callable, inputs,
                                layer: int = -1) -> list:
    """CCA similarity of consecutive checkpoints' representations of
    ``inputs`` (reference ``rc_rl.py:295-353``) -> one value per pair,
    written to ``<path>/cca_through_time.json``."""
    sims = []
    with torch.no_grad():
        for prev, cur in zip(checkpoint_params[:-1], checkpoint_params[1:]):
            a = _rows(rep_fn(prev, inputs))
            b = _rows(rep_fn(cur, inputs))
            # smaller axis first (see _similarities)
            ca, cb = (a, b) if a.shape[0] < a.shape[1] else (a.T, b.T)
            sims.append(get_cca_similarity(ca, cb, epsilon=1e-10)[1])
    with open(os.path.join(path, "cca_through_time.json"), "w") as f:
        json.dump(sims, f, indent=4)
    return sims
