"""Trajectory container and on-device rollout (port of
``exploring_meta_tpu/rl/rollout.py``).

A rollout is a fixed-shape time-major ``Trajectory``: ``[T, E, ...]`` for
one task, ``[B, T, E, ...]`` for a task batch (the port's collection
layout), ``[B, S, T, E, ...]`` for stacked replays. Every episode slot
runs exactly ``horizon`` steps. ``done`` marks the terminal transition;
``valid`` masks the steps after it (all losses are valid-weighted, PARITY
D7); the last valid step of every slot is forced done (the reference's
horizon-done wrapper).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Trajectory(NamedTuple):
    state: torch.Tensor       # [..., T, E, obs]
    action: torch.Tensor      # [..., T, E, act]
    reward: torch.Tensor      # [..., T, E]
    done: torch.Tensor        # [..., T, E] float: terminal transition
    next_state: torch.Tensor  # [..., T, E, obs]
    success: torch.Tensor     # [..., T, E] float
    valid: torch.Tensor       # [..., T, E] float: 1 = a real step
    timestep: torch.Tensor    # [..., T, E] int32 within-episode index

    @property
    def horizon(self) -> int:
        return self.reward.shape[-2]

    @property
    def n_episodes(self) -> int:
        return self.reward.shape[-1]

    def flat(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., T, E, ...]`` -> ``[..., T*E, ...]`` (time-major, as JAX
        flattens ``[T, E]``)."""
        lead = self.reward.ndim - 2
        return x.reshape(x.shape[:lead] + (-1,) + x.shape[lead + 2:])

    def map(self, fn) -> "Trajectory":
        """Apply ``fn`` to every field (index, move, stack...)."""
        return Trajectory(*(fn(x) for x in self))

    def episode_rewards(self) -> torch.Tensor:
        """``[..., E]`` sum of valid rewards per episode."""
        return (self.reward * self.valid).sum(dim=-2)

    def episode_successes(self) -> torch.Tensor:
        """``[..., E]`` 1 if any valid step flagged success (reference
        ``get_ep_successes``)."""
        return ((self.success * self.valid).sum(dim=-2) > 0).to(
            self.reward.dtype)


@torch.no_grad()
def rollout(env, policy_sample: Callable, params, task, gen: torch.Generator,
            episodes: int, horizon: int) -> Trajectory:
    """Collect ``episodes`` fixed-horizon episodes per goal of ``task``
    (``[2]`` or ``[B, 2]``) under ``policy_sample(params, gen, obs) ->
    actions``. Sampled actions are data: nothing here keeps a graph."""
    env_state, obs = env.reset(task, episodes)
    records = []
    for _ in range(horizon):
        actions = policy_sample(params, gen, obs)
        next_state, next_obs, reward, done, success = env.step(
            env_state, actions, task)
        valid = (~env_state.done).to(reward.dtype)
        # steps after termination carry zero reward and success, so the
        # advantage pipeline sees exactly the reference's replay contents
        records.append(Trajectory(
            state=obs, action=actions, reward=reward * valid,
            done=done.to(reward.dtype), next_state=next_obs,
            success=success * valid, valid=valid, timestep=env_state.t))
        env_state, obs = next_state, next_obs
    ax = task.ndim - 1      # the time axis
    traj = stack_trajectories(records, dim=ax)
    # horizon-done: the last valid step of each episode is terminal
    last = traj.done.select(ax, horizon - 1)
    last.copy_(torch.maximum(last, traj.valid.select(ax, horizon - 1)))
    return traj


def stack_trajectories(trajs, dim: int) -> Trajectory:
    """Stack Trajectories field by field along a new axis ``dim``."""
    return Trajectory(*(torch.stack(xs, dim=dim) for xs in zip(*trajs)))


def make_rollout(env, policy_sample: Callable, episodes: int, horizon: int):
    """``(params, task, gen) -> Trajectory``."""
    def roll(params, task, gen):
        return rollout(env, policy_sample, params, task, gen,
                       episodes=episodes, horizon=horizon)
    return roll
