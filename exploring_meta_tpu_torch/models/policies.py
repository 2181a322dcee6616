"""Gaussian MLP policy (port of ``DiagNormalPolicy`` from
``exploring_meta_tpu/models/policies.py``; reference
``core_functions/policies.py:30-67``).

Params are the JAX tree ``{"mean": [{"w": [in, out], "b": [out]}, ...],
"sigma": [act]}``: a relu (or tanh) MLP for the mean and a learned,
state-independent log-sigma clamped at ``log(1e-6)``. Per-task params
carry a leading ``[B]`` on every leaf; with them the state is ``[B, N,
obs]`` and the MLP runs as a batched matmul.

``log_prob`` keeps the reference's quirk of *averaging* (not summing) the
per-dimension log density over the action axis (``policies.py:54-56``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exploring_meta_tpu_torch.models import distributions as dist
from exploring_meta_tpu_torch.models import init as pinit
from exploring_meta_tpu_torch.models.layers import mlp_apply, task_param

EPSILON = 1e-6
MIN_LOG_SIGMA = math.log(EPSILON)


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` as the JAX package writes it (``jnp.maximum``): at a
    tie ``x == 0`` its gradient is 1/2, where ``torch.relu``'s is 0. Ties
    are common here: every episode starts at the origin and the biases
    start at zero, so the first steps' pre-activations are exactly 0."""
    return torch.maximum(x, x.new_zeros(()))


def _sigma(params) -> torch.Tensor:
    """``exp(clamp(sigma, min=log 1e-6))``, viewed to broadcast against
    ``[B, N, act]`` when it is per task."""
    return torch.exp(torch.clamp(task_param(params["sigma"], 1, 1),
                                 min=MIN_LOG_SIGMA))


class DiagNormalPolicy(NamedTuple):
    """Static spec; params are a separate tree."""
    input_size: int
    output_size: int
    hiddens: tuple = (100, 100)
    activation: str = "relu"

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Xavier-uniform weights, zero biases, ``sigma = 0`` (torch
        ``fill_(log 1)``)."""
        sizes = (self.input_size,) + tuple(self.hiddens) + (self.output_size,)
        dev = device or gen.device
        return {"mean": [pinit.linear_params(gen, i, o, init="xavier",
                                             device=dev)
                         for i, o in zip(sizes[:-1], sizes[1:])],
                "sigma": torch.zeros(self.output_size, device=dev)}

    def _act(self):
        return torch.tanh if self.activation == "tanh" else relu

    def density(self, params, state):
        """-> (loc, scale) of the diagonal Gaussian, both ``[..., act]``."""
        loc = mlp_apply(params["mean"], state, self._act())
        return loc, _sigma(params).expand(loc.shape)

    def log_prob(self, params, state, action) -> torch.Tensor:
        """-> ``[..., 1]``: the mean over action dims of the log density."""
        loc, scale = self.density(params, state)
        return dist.normal_log_prob(loc, scale, action).mean(dim=-1,
                                                             keepdim=True)

    def sample(self, params, gen: torch.Generator, state) -> torch.Tensor:
        loc, scale = self.density(params, state)
        return dist.normal_sample(gen, loc, scale)
