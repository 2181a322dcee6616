"""Diagonal-Gaussian and categorical distribution math (port of
``exploring_meta_tpu/models/distributions.py``; ``torch.distributions``'
``Normal``, ``Categorical`` and ``kl_divergence`` semantics, written out
elementwise)."""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def normal_log_prob(loc, scale, value) -> torch.Tensor:
    """Per-dimension Gaussian log density."""
    var = scale ** 2
    return -((value - loc) ** 2) / (2 * var) - torch.log(scale) - _LOG_SQRT_2PI


def normal_sample(gen, loc, scale) -> torch.Tensor:
    """``loc + scale * eps`` with ``eps ~ N(0, 1)`` drawn from ``gen`` (on
    the generator's device, which must be the tensors' device).

    ``gen`` may be a tuple of ``S`` seeds' generators (a one-program seed
    sweep, ``parallel/multiseed.py``): the leading axis of ``loc`` is then
    ``S`` equal shares, seed-major, and each share's noise is drawn from
    its seed's generator in the shape its solo run draws."""
    if isinstance(gen, tuple):
        eps = torch.cat([_standard_normal(g, part)
                         for g, part in zip(gen, loc.chunk(len(gen)))])
    else:
        eps = _standard_normal(gen, loc)
    return loc + scale * eps


def _standard_normal(gen: torch.Generator, like) -> torch.Tensor:
    return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def normal_kl(loc_p, scale_p, loc_q, scale_q) -> torch.Tensor:
    """Per-dimension KL(p || q) of diagonal Gaussians."""
    var_ratio = (scale_p / scale_q) ** 2
    t1 = ((loc_p - loc_q) / scale_q) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def categorical_sample(gen: torch.Generator, logits) -> torch.Tensor:
    """One category per row of ``logits [..., K]``, drawn from ``gen`` with
    probabilities ``softmax(logits)`` -> int64 ``[...]``."""
    probs = torch.softmax(logits.float(), dim=-1)
    # torch.multinomial's one-draw path, an exponential race (argmax of
    # p / q, q ~ Exp(1)): the same draws from the same generator, without
    # its host-synced input checks, so that a CUDA graph can capture it
    q = torch.empty_like(probs).exponential_(generator=gen)
    return (probs / q).argmax(dim=-1)


def categorical_log_prob(logits, value) -> torch.Tensor:
    """``log softmax(logits)`` at the integer categories ``value [...]``."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, value.long().unsqueeze(-1)).squeeze(-1)
