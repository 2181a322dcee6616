"""Replay-based meta-gradients for PPO and VPG (port of
``exploring_meta_tpu/rl/replay_meta.py``; the reference's TRPO
replay-and-rederive trick, ``core_functions/rl.py:441-473``, applied to
the Adam paths).

1. Collect: run the inner loop once with a real rollout function,
   recording every trajectory (the support batch of each step, then the
   query batch).
2. Rederive: run ``fast_adapt_*`` again under autograd with a feeder that
   returns the recorded trajectories in order. An inner update is a
   deterministic function of (params, trajectory), so the rerun rebuilds
   the collection-time adaptation, now with its second-order graph.

Trajectories are task batches: the recorded ones are ``[B, T, E, ...]``
and the stacked replays ``[B, steps + 1, T, E, ...]``. On identical
replays the meta-loss and meta-gradient are deterministic functions of
the params, which is how the tests hold the port against JAX and the card
against the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch

from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, fast_adapt_ppo, fast_adapt_vpg,
)
from exploring_meta_tpu_torch.rl.rollout import Trajectory, stack_trajectories

_FAST_ADAPT = {"ppo": fast_adapt_ppo, "vpg": fast_adapt_vpg}


def _fast_adapt(algo: str, caller: str) -> Callable:
    if algo not in _FAST_ADAPT:
        raise ValueError(f"{caller}: unsupported algo {algo!r} (TRPO "
                         "replays through rl/trpo_meta.py)")
    return _FAST_ADAPT[algo]


def recording_rollout(rollout_fn: Callable, store: list) -> Callable:
    """Wrap a rollout function to append every Trajectory it returns to
    ``store``."""
    def roll(params, tasks, gen):
        traj = rollout_fn(params, tasks, gen)
        store.append(traj)
        return traj
    return roll


def replay_feeder(replays: Trajectory) -> Callable:
    """A rollout function that returns the recorded ``replays [B, S, T,
    E, ...]`` one step ``[:, i]`` a call, in order, whatever its
    arguments."""
    counter = iter(range(replays.reward.shape[1]))

    def roll(params, tasks, gen):
        i = next(counter)
        return replays.map(lambda x: x[:, i])
    return roll


def collect_replays(algo: str, policy, params, rollout_fn: Callable, tasks,
                    gen: torch.Generator, cfg: RLConfig):
    """Collection pass for a task batch, under ``torch.no_grad()`` ->
    (stacked replays ``[B, steps + 1, T, E, ...]``, query metrics)."""
    fast_adapt = _fast_adapt(algo, "collect_replays")
    store: list = []
    with torch.no_grad():
        _, _, metrics = fast_adapt(policy, params,
                                   recording_rollout(rollout_fn, store),
                                   tasks, gen, cfg)
    return stack_trajectories(store, dim=1), metrics


def make_replay_meta_loss(algo: str, policy, cfg: RLConfig) -> Callable:
    """-> ``meta_loss(params, stacked_replays)``: the mean over tasks of the
    query loss of ``fast_adapt_{algo}`` rerun on the replays, with the
    shared ``params`` differentiable to second order."""
    fast_adapt = _fast_adapt(algo, "make_replay_meta_loss")

    def meta_loss(params, stacked_replays: Trajectory) -> torch.Tensor:
        B = stacked_replays.reward.shape[0]
        _, losses, _ = fast_adapt(policy, params,
                                  replay_feeder(stacked_replays),
                                  stacked_replays.reward.new_zeros(B), None,
                                  cfg)
        return losses.mean()

    return meta_loss
