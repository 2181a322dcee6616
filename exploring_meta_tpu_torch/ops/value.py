"""Linear value-function baseline (port of
``exploring_meta_tpu/ops/value.py``; ``cherry.models.robotics.LinearValue``).

Features are ``[s, s^2, t/100, (t/100)^2, (t/100)^3, 1]`` with ``t`` the
explicit per-step timestep the caller passes. The fit is a closed-form
ridge solve, batched over any leading axes (a task axis ``[B]``), and is
never differentiated through: its result is detached, as JAX
``stop_gradient``-s it.
"""

from __future__ import annotations

import torch


def linear_value_features(states: torch.Tensor,
                          timesteps: torch.Tensor) -> torch.Tensor:
    """``[..., N, *obs]`` states (flattened past ``N``, as JAX flattens a
    pixel or scalar state) and ``[..., N]`` timesteps -> ``[..., N, 2 *
    obs + 4]``."""
    states = states.reshape(tuple(timesteps.shape) + (-1,))
    al = timesteps.to(states.dtype).unsqueeze(-1) / 100.0
    return torch.cat([states, states ** 2, al, al ** 2, al ** 3,
                      torch.ones_like(al)], dim=-1)


def fit_linear_value(states, timesteps, returns, reg: float = 1e-5,
                     weights=None) -> torch.Tensor:
    """Solve ``(F^T W F + reg I) w = F^T W R`` -> detached weights
    ``[..., D, 1]``. ``weights`` ``[..., N]`` (a validity mask) drops padded
    steps out of the fit.

    ``solve_ex`` does not check the factorization on the host, so the fit
    needs no device sync; the system is positive definite for ``reg > 0``."""
    with torch.no_grad():
        f = linear_value_features(states, timesteps)
        r = returns.to(f.dtype).unsqueeze(-1)
        if weights is not None:
            sw = torch.sqrt(weights.to(f.dtype)).unsqueeze(-1)
            f = f * sw
            r = r * sw
        ft = f.transpose(-1, -2)
        a = ft @ f + reg * torch.eye(f.shape[-1], dtype=f.dtype,
                                     device=f.device)
        w, _ = torch.linalg.solve_ex(a, ft @ r)
    return w


def linear_value(weights, states, timesteps) -> torch.Tensor:
    """The fitted baseline -> ``[..., N, 1]`` values."""
    return linear_value_features(states, timesteps) @ weights
