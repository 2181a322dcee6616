"""Discounted returns and Generalized Advantage Estimation (port of
``exploring_meta_tpu/ops/gae.py``).

Arrays are ``[T]``, ``[T, E]`` (E parallel episodes, or ``[T, 1]`` for the
reference's flat concatenated replay) or a task batch ``[B, T, E]``. Time
is axis 0, or axis 1 when there is a task axis. ``done`` flags reset the
accumulation at episode boundaries.

As in JAX, a zero bootstrap (every call on the training path) goes to the
reverse-sweep kernels of :mod:`exploring_meta_tpu_torch.cuda.gae_cuda`
(the plain twins on the CPU); a non-zero ``bootstrap`` / ``next_value``
takes the plain formulation. There is no switch between the two.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.cuda import gae_cuda


def _is_zero(x) -> bool:
    return isinstance(x, (int, float)) and x == 0.0


def discount(gamma: float, rewards: torch.Tensor, dones: torch.Tensor,
             bootstrap=0.0) -> torch.Tensor:
    """``R_t = r_t + gamma * (1 - done_t) * R_{t+1}`` in reverse, with
    ``R_T = bootstrap`` (``cherry.td.discount``)."""
    dones = dones.to(rewards.dtype)
    if _is_zero(bootstrap):
        return gae_cuda.discount_sweep(gamma, rewards.contiguous(),
                                       dones.contiguous())
    return gae_cuda.discount_plain(gamma, rewards, dones, bootstrap)


def temporal_difference(gamma: float, rewards, dones, values,
                        next_values) -> torch.Tensor:
    """One-step TD errors ``r_t + gamma * (1 - d_t) * V_{t+1} - V_t``."""
    dones = dones.to(values.dtype)
    return rewards + gamma * (1.0 - dones) * next_values - values


def generalized_advantage(gamma: float, tau: float, rewards, dones, values,
                          next_value=0.0) -> torch.Tensor:
    """GAE(gamma, tau) (``cherry.pg.generalized_advantage``): TD errors
    against ``values`` shifted one step with ``next_value`` appended, then
    discounted by ``gamma * tau`` with reset at dones."""
    dones = dones.to(rewards.dtype)
    if _is_zero(next_value):
        return gae_cuda.gae_sweep(gamma, tau, rewards.contiguous(),
                                  dones.contiguous(), values.contiguous())
    ax = 1 if values.ndim == 3 else 0    # the time axis
    nv = torch.as_tensor(next_value, dtype=values.dtype,
                         device=values.device)
    nv = nv.expand(values.shape[:ax] + values.shape[ax + 1:]).unsqueeze(ax)
    next_values = torch.cat([values.narrow(ax, 1, values.shape[ax] - 1), nv],
                            dim=ax)
    td = temporal_difference(gamma, rewards, dones, values, next_values)
    return discount(gamma * tau, td, dones)


def compute_advantages(tau: float, gamma: float, rewards, dones, values,
                       next_state_values) -> torch.Tensor:
    """The reference's advantage pipeline (``core_functions/rl.py:95-110``):
    at a terminal step GAE sees ``V(s'_t)`` in place of ``V(s_t)``
    (``bootstraps = values * (1 - d) + next_values * d``), and the trailing
    bootstrap is zero. The baseline is fitted by the caller."""
    dones_f = dones.to(values.dtype)
    bootstraps = values * (1.0 - dones_f) + next_state_values * dones_f
    return generalized_advantage(gamma, tau, rewards, dones, bootstraps, 0.0)
