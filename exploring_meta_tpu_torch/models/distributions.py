"""Diagonal-Gaussian distribution math (port of the Gaussian part of
``exploring_meta_tpu/models/distributions.py``; ``torch.distributions.Normal``
and ``kl_divergence`` semantics, written out elementwise)."""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def normal_log_prob(loc, scale, value) -> torch.Tensor:
    """Per-dimension Gaussian log density."""
    var = scale ** 2
    return -((value - loc) ** 2) / (2 * var) - torch.log(scale) - _LOG_SQRT_2PI


def normal_sample(gen: torch.Generator, loc, scale) -> torch.Tensor:
    """``loc + scale * eps`` with ``eps ~ N(0, 1)`` drawn from ``gen`` (on
    the generator's device, which must be the tensors' device)."""
    eps = torch.randn(loc.shape, generator=gen, dtype=loc.dtype,
                      device=loc.device)
    return loc + scale * eps


def normal_kl(loc_p, scale_p, loc_q, scale_q) -> torch.Tensor:
    """Per-dimension KL(p || q) of diagonal Gaussians."""
    var_ratio = (scale_p / scale_q) ** 2
    t1 = ((loc_p - loc_q) / scale_q) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
