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

On a host env (MuJoCo, Meta-World) each row adapts step by step with the
analysis-side inner update (``single_adapt_step``, one clipped PPO update)
and records its per-step progress in ``cl_exp/adapt_progress.json``;
``one_per_task`` builds the matrix over one task of every distinct task id
(the reference's ML10 mode), and a ``grouped_roll_factory``
(``envs/host.py``) adapts all rows in lockstep and measures each row in one
grouped rollout.
"""

from __future__ import annotations

import json
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd, per_task
from exploring_meta_tpu_torch.ops.cl_metrics import calc_cl_metrics
from exploring_meta_tpu_torch.ops.losses import accuracy, cross_entropy
from exploring_meta_tpu_torch.rl.adapt_rl import (
    _query_metrics, single_adapt_step,
)
from exploring_meta_tpu_torch.rl.evaluate import (
    adapt_tasks, sample_3_from_each_task,
)
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


def _as_np(rows: list) -> np.ndarray:
    return torch.stack(rows).cpu().numpy().astype(np.float64)


def _wide(adapted, n: int):
    """One task's adapted params ``[1, ...]`` broadcast to ``n`` tasks."""
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape[1:])), adapted)


def cl_rl_matrix(algo: str, policy, params, tasks, rollout_fn: Callable,
                 eval_roll: Callable, cfg, gen: torch.Generator) -> tuple:
    """The RL CL matrices of a task batch ``tasks [n, ...]`` -> ``(reward
    [n, n], success [n, n])`` float64: row i adapts ``params`` on task i
    (``fast_adapt_<algo>``, no graph), broadcasts the adapted policy to all
    n tasks and measures it in one batched ``eval_roll``."""
    n = len(tasks)
    rews, sucs = [], []
    for i in range(n):
        adapted = adapt_tasks(algo, policy, params, rollout_fn,
                              tasks[i:i + 1], gen, cfg)
        m = _query_metrics(eval_roll(_wide(adapted, n), tasks, gen))
        rews.append(m["reward"])
        sucs.append(m["success"])
    return _as_np(rews), _as_np(sucs)


def sample_one_from_each_task(env, gen, pool: int = 50) -> list:
    """One task of every distinct task id (reference
    ``sample_from_each_task``, ``cl_rl.py:187-198``): the ML10 CL matrix
    covers each benchmark task once."""
    return sample_3_from_each_task(env, gen, pool=pool, per_task=1)


def _record(progress: dict, step: int, rews, sucs, first: int = 0) -> None:
    """The support reward and success of adaptation ``step`` of tasks
    ``first``, ``first + 1``, ..."""
    for i, (r, s) in enumerate(zip(rews.tolist(), sucs.tolist()), first):
        key = f"task_{i + 1}"
        progress["reward"].setdefault(key, {})[f"step_{step}"] = r
        progress["success"].setdefault(key, {})[f"step_{step}"] = s


@torch.no_grad()
def cl_rl_host_matrix(algo: str, policy, params, tasks, rollout_fn: Callable,
                      cfg, gen: torch.Generator,
                      grouped_roll_factory: Callable | None = None) -> tuple:
    """The RL CL matrices on a host env -> ``(reward [n, n], success [n,
    n], progress)``: row i adapts ``params`` on task i step by step
    (``single_adapt_step``, the analysis-side update), recording each
    step's support reward and success in ``progress`` (reference
    ``cl_rl.py:59-91``), then measures the adapted policy on every task.
    Per task (JAX's eager loop: row i's adaptation, then its n rollouts,
    one task at a time), or with ``grouped_roll_factory`` all n
    adaptations in lockstep and each row in one grouped rollout."""
    n = len(tasks)
    progress: dict = {"reward": {}, "success": {}}
    rews, sucs = [], []
    if grouped_roll_factory is not None:
        grouped = grouped_roll_factory(n)
        cur = per_task(params, n)
        for step in range(cfg.adapt_steps):
            support = grouped(cur, tasks, gen)
            m = _query_metrics(support)
            _record(progress, step, m["reward"], m["success"])
            cur = single_adapt_step(algo, policy, cur, support, cfg)
        for i in range(n):
            m = _query_metrics(grouped(_wide(tree_map(lambda x: x[i:i + 1],
                                                      cur), n), tasks, gen))
            rews.append(m["reward"])
            sucs.append(m["success"])
        return _as_np(rews), _as_np(sucs), progress
    for i in range(n):
        p = per_task(params, 1)
        for step in range(cfg.adapt_steps):
            support = rollout_fn(p, tasks[i:i + 1], gen)
            p = single_adapt_step(algo, policy, p, support, cfg)
            m = _query_metrics(support)
            _record(progress, step, m["reward"], m["success"], first=i)
        m = _query_metrics(rollout_fn(_wide(p, n), tasks, gen))
        rews.append(m["reward"])
        sucs.append(m["success"])
    return _as_np(rews), _as_np(sucs), progress


def run_cl_rl_exp(path, policy, params, env, rollout_fn: Callable, cfg,
                  gen: torch.Generator, n_tasks: int = 5, algo: str = "trpo",
                  eval_batch_size: int | None = None,
                  normalize_rewards: bool = False,
                  one_per_task: bool = False,
                  grouped_roll_factory: Callable | None = None) -> tuple:
    """RL CL experiment -> ``(rew_matrix, cl_res_rew, cl_res_suc)``
    (reference ``run_cl_rl_exp``, ``cl_rl.py:26-153``), written to
    ``<path>/cl_exp/``. On a device env, matrix cells are measured with
    ``eval_batch_size`` episodes where given (reference
    ``cl_rl.py:105-107``; a host vec env's slot count is fixed, as in JAX).
    ``normalize_rewards`` scales each row to unit L2 norm (sklearn
    ``normalize``, ``cl_rl.py:127-133``). ``one_per_task`` and
    ``grouped_roll_factory``: see :func:`cl_rl_host_matrix` and
    :func:`sample_one_from_each_task`; a host env also writes
    ``adapt_progress.json``."""
    if algo not in ("vpg", "ppo", "trpo"):
        raise ValueError(f"unknown adaptation algo {algo!r}")
    cl_path = os.path.join(path, "cl_exp")
    os.makedirs(cl_path, exist_ok=True)

    if one_per_task:
        tasks = sample_one_from_each_task(env, gen)
        n_tasks = len(tasks)
    else:
        tasks = env.sample_tasks(gen, n_tasks)
    host_env = hasattr(env, "collect")
    if host_env:
        rew_matrix, suc_matrix, progress = cl_rl_host_matrix(
            algo, policy, params, tasks, rollout_fn, cfg, gen,
            grouped_roll_factory)
    else:
        eval_roll = rollout_fn
        if eval_batch_size is not None:
            from exploring_meta_tpu_torch.rl.rollout import make_rollout
            eval_roll = make_rollout(env, policy.sample,
                                     episodes=eval_batch_size,
                                     horizon=cfg.max_path_length)
        rew_matrix, suc_matrix = cl_rl_matrix(algo, policy, params, tasks,
                                              rollout_fn, eval_roll, cfg,
                                              gen)
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
    if host_env:
        _write_json(os.path.join(cl_path, "adapt_progress.json"), progress)
    return rew_matrix, cl_res_rew, cl_res_suc
