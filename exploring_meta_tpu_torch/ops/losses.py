"""Vision and policy-gradient losses (port of
``exploring_meta_tpu/ops/losses.py``, less PPO and DiCE).

Every loss gives one value per task: the vision losses reduce over the
example axis only (``[B, N, C]`` logits with ``[B, N]`` labels), the
policy losses over every axis but the leading task axis ``[B]``.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels
    (``torch.nn.CrossEntropyLoss(reduction='mean')`` per task)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.mean(dim=-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Classification accuracy per task."""
    return (logits.argmax(dim=-1) == labels).float().mean(dim=-1)


def _loss_mean(x: torch.Tensor, valid=None) -> torch.Tensor:
    """Per-task mean over every axis but the first: plain (cherry
    semantics) or valid-weighted over the fixed-shape trajectory layout
    (deviations registry D7)."""
    if valid is None:
        return x.flatten(1).mean(dim=1)
    v = valid.expand_as(x).flatten(1)
    return (x.flatten(1) * v).sum(dim=1) / v.sum(dim=1).clamp(min=1.0)


def a2c_policy_loss(log_probs, advantages, valid=None) -> torch.Tensor:
    """``-(log pi(a|s) * A).mean()`` per task (cherry
    ``a2c.policy_loss``); ``valid`` masks padded steps."""
    return -_loss_mean(log_probs * advantages, valid)


def trpo_policy_loss(new_log_probs, old_log_probs, advantages,
                     valid=None) -> torch.Tensor:
    """Unclipped importance-ratio surrogate per task (cherry
    ``trpo.policy_loss``); ``valid`` masks padded steps."""
    ratio = torch.exp(new_log_probs - old_log_probs)
    return -_loss_mean(ratio * advantages, valid)
