"""Task-batched collection for host-physics meta-RL (port of
``exploring_meta_tpu/rl/host_batched.py``).

Per-task host collection (``trainers/rl.py``'s per-task iterations) steps
one task's episodes at a time: ``meta_batch x (adapt_steps + 1) x
horizon`` policy round trips an iteration. Here the whole meta-batch
collects in lockstep through one ``n_tasks * episodes``-slot vec env
(``envs/host.py:make_grouped_host_rollout``), with the first-order inner
updates of all tasks between the rollout phases: ``(adapt_steps + 1) x
horizon`` round trips. The task axis is the port's leading ``[B]``
already, so JAX's ``vmap`` over tasks is the batched
``single_adapt_step`` and ``_query_metrics`` as they stand.

The losses and inner updates are per-task collection's (reference
``fast_adapt_trpo / ppo / vpg``, ``core_functions/rl.py:229-406``); only
the host scheduling changes. The replays feed the same outer steps:
``rl/trpo_meta.py`` for TRPO, ``rl/replay_meta.py`` for PPO and VPG.
"""

from __future__ import annotations

from typing import Callable

import torch

from exploring_meta_tpu_torch.adapt.maml import per_task
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, _query_metrics, single_adapt_step,
)
from exploring_meta_tpu_torch.rl.rollout import stack_trajectories


def broadcast_params(params, n_tasks: int):
    """The shared params as ``[n_tasks]``-stacked copies."""
    return per_task(params, n_tasks)


@torch.no_grad()
def _adapt(algo, policy, params, grouped_roll, tasks, gen, cfg):
    """``cfg.adapt_steps`` grouped support rollouts, each followed by every
    task's first-order inner step with ``fast_adapt_<algo>``'s semantics
    (``cfg.ppo_epochs`` clipped PPO updates)."""
    cur = broadcast_params(params, len(tasks))
    replay = []
    for _ in range(cfg.adapt_steps):
        support = grouped_roll(cur, tasks, gen)
        replay.append(support)
        cur = single_adapt_step(algo, policy, cur, support, cfg,
                                ppo_epochs=cfg.ppo_epochs)
    return cur, replay


def adapt_task_batched(algo: str, policy, params, grouped_roll: Callable,
                       tasks, gen: torch.Generator, cfg: RLConfig):
    """``cfg.adapt_steps`` batched support rollouts with every task's inner
    update between them, and no query rollout -> ``(adapted params [B,
    ...], support replays [B, adapt_steps, T, E, ...] or None when
    adapt_steps is 0)``. Evaluation measures its own rollout afterwards."""
    cur, replay = _adapt(algo, policy, params, grouped_roll, tasks, gen, cfg)
    return cur, stack_trajectories(replay, dim=1) if replay else None


def collect_task_batched(algo: str, policy, params, grouped_roll: Callable,
                         tasks, gen: torch.Generator, cfg: RLConfig):
    """One meta-batch collection, task-batched.

    ``grouped_roll(params [B, ...], tasks, gen) -> Trajectory [B, T, E,
    ...]``. -> ``(adapted params [B, ...], replays [B, adapt_steps + 1, T,
    E, ...]`` (the stacked-replay layout of the outer steps), ``metrics``:
    the query rollout's reward and success, device scalars)."""
    cur, replay = _adapt(algo, policy, params, grouped_roll, tasks, gen, cfg)
    query = grouped_roll(cur, tasks, gen)
    replay.append(query)
    ms = _query_metrics(query)
    return cur, stack_trajectories(replay, dim=1), {
        "reward": ms["reward"].mean(), "success": ms["success"].mean()}
