"""Continual-learning transfer experiments, vision and RL (port of
``exploring_meta_tpu/analysis/cl.py``; reference
``misc_scripts/cl_vision.py`` / ``cl_rl.py``): adapt a fresh copy of the
meta-trained model on task i, evaluate it on every task j, collect the
N x N matrix and its CL metrics (``ops/cl_metrics.py``).

Vision settings (reference ``cl_vision.py:3-6``):
  1 - evaluate on the SAME samples used for adaptation;
  2 - evaluate on held-out query samples of the same classes.

Sampling the task pool and computing the matrix are two steps
(``sample_task_batch`` then :func:`cl_matrix`; ``env.sample_tasks`` then
:func:`cl_rl_matrix`), so that a pool drawn elsewhere (the JAX package's,
replayed) can be fed to the matrix; ``run_*`` composes them under the JAX
signature, with a ``torch.Generator`` in place of the key. Batch-stat BN
stays per task: the eval sets are one ``[n, N, ...]`` task batch, never
``n * N`` images.
Host envs (their per-step adaptation progress and one-per-task matrices)
are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd
from exploring_meta_tpu_torch.envs.factory import HOST_ENVS
from exploring_meta_tpu_torch.ops.cl_metrics import calc_cl_metrics
from exploring_meta_tpu_torch.ops.losses import accuracy, cross_entropy
from exploring_meta_tpu_torch.rl.adapt_rl import _query_metrics
from exploring_meta_tpu_torch.rl.evaluate import adapt_tasks
from exploring_meta_tpu_torch.tasks.sampler import (
    sample_task_batch, split_support_query,
)
from exploring_meta_tpu_torch.utils.tree import tree_map


def save_acc_matrix(path: str, acc_matrix, name: str = "acc_matrix") -> None:
    np.savetxt(os.path.join(path, f"{name}.out"), np.asarray(acc_matrix),
               fmt="%1.2f")


class CLMatrix(NamedTuple):
    acc: np.ndarray        # [n, n] float64: row i adapted on task i
    adapted: list          # per row: the adapted params (ANIL: the head)
    logits: torch.Tensor   # [n, n, eval examples, ways]


def cl_matrix(apply_fn: Callable, params, data, labels, ways: int,
              shots: int, inner_lr: float, adapt_steps: int,
              setting: int = 1, features_fn: Callable | None = None,
              head_apply: Callable | None = None) -> CLMatrix:
    """The vision CL matrix of a task pool ``(data [n, N, ...], labels [n,
    N])``: row i adapts ``params`` on task i's support set (``inner_sgd``,
    one task) and evaluates the adapted model on all n eval sets in one
    ``[n, ...]`` call.

    ANIL (``features_fn`` and ``head_apply``): the body encodes each task's
    whole sampled data, support and query, in one BN batch before the
    split (reference ``prepare_batch(features=...)``, JAX ``cl.py:56-60``),
    and only the head adapts, on those frozen features."""
    with torch.no_grad():
        if features_fn is not None:
            data = features_fn(params, data)
            adapt_params = params["head"]
            fwd = lambda head, x: head_apply({"head": head}, x)
        else:
            adapt_params, fwd = params, apply_fn
        (xs, ys), (xq, yq) = split_support_query(data, labels, shots, ways)
        ex, ey = (xs, ys) if setting == 1 else (xq, yq)

        def loss_fn(p, batch):
            return cross_entropy(fwd(p, batch[0]), batch[1])

        rows, logits, adapted_rows = [], [], []
        for i in range(data.shape[0]):
            adapted = inner_sgd(loss_fn, adapt_params, (xs[i], ys[i]),
                                inner_lr, adapt_steps)
            lg = fwd(adapted, ex)
            rows.append(accuracy(lg, ey))
            logits.append(lg)
            adapted_rows.append(adapted)
        acc = torch.stack(rows).cpu().numpy().astype(np.float64)
    return CLMatrix(acc=acc, adapted=adapted_rows, logits=torch.stack(logits))


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=True, indent=4)


def run_cl_exp(path, apply_fn: Callable, params, dataset, ways: int,
               shots: int, gen: torch.Generator, cl_params: dict | None = None,
               setting: int = 1, features_fn: Callable | None = None,
               head_apply: Callable | None = None) -> tuple:
    """Vision CL experiment -> ``(acc_matrix, metrics dict)``, written to
    ``<path>/cl_exp/`` (``acc_matrix.out``, ``cl_params.json``,
    ``cl_res.json``). ``apply_fn(params, x) -> logits``; for ANIL runs pass
    ``features_fn`` (the body encoder) and ``head_apply``."""
    cl_params = dict(cl_params or {"adapt_steps": 1, "inner_lr": 0.1,
                                   "n_tasks": 10})
    cl_path = os.path.join(path, "cl_exp")
    os.makedirs(cl_path, exist_ok=True)
    # one draw of n tasks (JAX draws them one sample_task at a time; the
    # law is the same)
    data, labels = sample_task_batch(gen, dataset, ways, shots,
                                     cl_params["n_tasks"])
    acc_matrix = cl_matrix(apply_fn, params, data, labels, ways, shots,
                           cl_params["inner_lr"], cl_params["adapt_steps"],
                           setting=setting, features_fn=features_fn,
                           head_apply=head_apply).acc
    cl_res = calc_cl_metrics(acc_matrix)
    save_acc_matrix(cl_path, acc_matrix)
    _write_json(os.path.join(cl_path, "cl_params.json"), cl_params)
    _write_json(os.path.join(cl_path, "cl_res.json"), cl_res)
    return acc_matrix, cl_res


def cl_rl_matrix(algo: str, policy, params, tasks, rollout_fn: Callable,
                 eval_roll: Callable, cfg, gen: torch.Generator) -> tuple:
    """The RL CL matrices of a task batch ``tasks [n, ...]`` -> ``(reward
    [n, n], success [n, n])`` float64: row i adapts ``params`` on task i
    (``fast_adapt_<algo>``, no graph), broadcasts the adapted policy to all
    n tasks and measures it in one batched ``eval_roll``."""
    n = tasks.shape[0]
    rews, sucs = [], []
    for i in range(n):
        adapted = adapt_tasks(algo, policy, params, rollout_fn,
                              tasks[i:i + 1], gen, cfg)
        wide = tree_map(lambda x: x.expand((n,) + tuple(x.shape[1:])),
                        adapted)
        m = _query_metrics(eval_roll(wide, tasks, gen))
        rews.append(m["reward"])
        sucs.append(m["success"])
    as_np = lambda rows: torch.stack(rows).cpu().numpy().astype(np.float64)
    return as_np(rews), as_np(sucs)


def run_cl_rl_exp(path, policy, params, env, rollout_fn: Callable, cfg,
                  gen: torch.Generator, n_tasks: int = 5, algo: str = "trpo",
                  eval_batch_size: int | None = None,
                  normalize_rewards: bool = False,
                  one_per_task: bool = False,
                  grouped_roll_factory: Callable | None = None) -> tuple:
    """RL CL experiment on a device env -> ``(rew_matrix, cl_res_rew,
    cl_res_suc)`` (reference ``run_cl_rl_exp``, ``cl_rl.py:26-153``),
    written to ``<path>/cl_exp/``. Matrix cells are measured with
    ``eval_batch_size`` episodes where given (reference
    ``cl_rl.py:105-107``); ``normalize_rewards`` scales each row to unit
    L2 norm (sklearn ``normalize``, ``cl_rl.py:127-133``)."""
    if algo not in ("vpg", "ppo", "trpo"):
        raise ValueError(f"unknown adaptation algo {algo!r}")
    if one_per_task or grouped_roll_factory is not None \
            or hasattr(env, "collect"):
        raise NotImplementedError(f"run_cl_rl_exp: {HOST_ENVS}")
    cl_path = os.path.join(path, "cl_exp")
    os.makedirs(cl_path, exist_ok=True)

    tasks = env.sample_tasks(gen, n_tasks)
    eval_roll = rollout_fn
    if eval_batch_size is not None:
        from exploring_meta_tpu_torch.rl.rollout import make_rollout
        eval_roll = make_rollout(env, policy.sample,
                                 episodes=eval_batch_size,
                                 horizon=cfg.max_path_length)
    rew_matrix, suc_matrix = cl_rl_matrix(algo, policy, params, tasks,
                                          rollout_fn, eval_roll, cfg, gen)
    if normalize_rewards:
        norms = np.linalg.norm(rew_matrix, axis=1, keepdims=True)
        rew_matrix = rew_matrix / np.maximum(norms, 1e-12)

    cl_res_rew = calc_cl_metrics(rew_matrix)
    cl_res_suc = calc_cl_metrics(suc_matrix)
    save_acc_matrix(cl_path, rew_matrix, name="cl_rew_matrix")
    save_acc_matrix(cl_path, suc_matrix, name="cl_suc_matrix")
    _write_json(os.path.join(cl_path, "cl_res_rew.json"), cl_res_rew)
    _write_json(os.path.join(cl_path, "cl_res_suc.json"), cl_res_suc)
    _write_json(os.path.join(cl_path, "cl_params.json"), {
        "algo": algo, "n_tasks": n_tasks, "adapt_steps": cfg.adapt_steps,
        "adapt_batch_size": cfg.adapt_batch_size, "inner_lr": cfg.inner_lr,
        "gamma": cfg.gamma, "tau": cfg.tau,
        "max_path_length": cfg.max_path_length,
        "normalize_rewards": normalize_rewards,
        "one_per_task": one_per_task})
    return rew_matrix, cl_res_rew, cl_res_suc
