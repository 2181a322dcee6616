"""Particles2D: goal-conditioned 2D point navigation on the device (port of
``exploring_meta_tpu/envs/particles2d.py``; l2l.gym's ``Particles2D-v1``).

A point starts at the origin; an action is a displacement clipped to
+-0.1; the reward is minus the Euclidean distance to the task's goal; the
episode ends when BOTH coordinates are within 0.01 of the goal (l2l's
per-coordinate box, PARITY D5), and the point stays frozen from then on.
A task is a goal drawn uniformly from ``[-0.5, 0.5]^2``.

The env is batched: a goal ``task [..., 2]`` drives ``E`` episodes, so the
state is ``[..., E, 2]`` (a task batch ``[B, 2]`` gives ``[B, E, 2]``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EnvState(NamedTuple):
    pos: torch.Tensor    # [..., E, 2]
    t: torch.Tensor      # [..., E] int32 step counter
    done: torch.Tensor   # [..., E] bool: the episode has terminated


class Particles2D(NamedTuple):
    max_action: float = 0.1
    goal_threshold: float = 0.01
    obs_size: int = 2
    action_size: int = 2

    def sample_tasks(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """-> ``[n, 2]`` goals ~ U[-0.5, 0.5]^2, on the generator's device."""
        u = torch.rand((n, 2), generator=gen, device=gen.device)
        return u - 0.5

    def reset(self, task: torch.Tensor, episodes: int):
        """-> (state, obs) of ``episodes`` episodes per goal, at the origin."""
        shape = task.shape[:-1] + (episodes,)
        pos = task.new_zeros(shape + (2,))
        state = EnvState(pos=pos,
                         t=torch.zeros(shape, dtype=torch.int32,
                                       device=task.device),
                         done=torch.zeros(shape, dtype=torch.bool,
                                          device=task.device))
        return state, pos

    def step(self, state: EnvState, action: torch.Tensor, task: torch.Tensor):
        """-> (next_state, obs, reward, done, success); a terminated
        episode stays where it is (the rollout masks its steps out)."""
        action = torch.clamp(action, -self.max_action, self.max_action)
        new_pos = torch.where(state.done.unsqueeze(-1), state.pos,
                              state.pos + action)
        diff = new_pos - task.unsqueeze(-2)
        reward = -torch.linalg.vector_norm(diff, dim=-1)
        done_now = (diff.abs() < self.goal_threshold).all(dim=-1)
        done = state.done | done_now
        next_state = EnvState(pos=new_pos, t=state.t + 1, done=done)
        return next_state, new_pos, reward, done, done_now.to(new_pos.dtype)
