"""Vision and policy-gradient losses, and DiCE (port of
``exploring_meta_tpu/ops/losses.py``).

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


def ppo_policy_loss(new_log_probs, old_log_probs, advantages,
                    clip: float = 0.1, valid=None) -> torch.Tensor:
    """Clipped importance-ratio surrogate per task (cherry
    ``ppo.policy_loss``); ``valid`` masks padded steps.

    The clip and the min are written as JAX writes them (``jnp.clip`` is
    ``minimum(maximum(x, lo), hi)``), so a tie splits its gradient 1/2 to
    each side there too; ``torch.clamp`` would pass all of it at a bound."""
    ratio = torch.exp(new_log_probs - old_log_probs)
    obj = ratio * advantages
    # new_full fills on the device: no host-to-device copy, which a CUDA
    # graph could not capture
    lo, hi = ratio.new_full((), 1.0 - clip), ratio.new_full((), 1.0 + clip)
    clipped = torch.minimum(torch.maximum(ratio, lo), hi)
    return -_loss_mean(torch.minimum(obj, clipped * advantages), valid)


def trpo_policy_loss(new_log_probs, old_log_probs, advantages,
                     valid=None) -> torch.Tensor:
    """Unclipped importance-ratio surrogate per task (cherry
    ``trpo.policy_loss``); ``valid`` masks padded steps."""
    ratio = torch.exp(new_log_probs - old_log_probs)
    return -_loss_mean(ratio * advantages, valid)


def magic_box(x: torch.Tensor) -> torch.Tensor:
    """DiCE magic box ``exp(x - x.detach())`` (l2l ``magic_box``): 1 in
    value, the gradient of ``exp(x)`` at the detached point."""
    return torch.exp(x - x.detach())


def weighted_cumsum(values: torch.Tensor, weights: torch.Tensor,
                    dim: int = 0) -> torch.Tensor:
    """Forward recurrence ``y_t = v_t + w_t * y_{t-1}`` (``y_{-1} = 0``)
    along ``dim``, differentiable in both inputs; the DiCE VPG variant's
    (reference ``core_functions/rl.py:202-205``)."""
    ys, y = [], torch.zeros_like(values.select(dim, 0))
    for v, w in zip(values.unbind(dim), weights.unbind(dim)):
        y = v + w * y
        ys.append(y)
    return torch.stack(ys, dim=dim)
