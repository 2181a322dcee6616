"""Vision losses (port of the vision part of
``exploring_meta_tpu/ops/losses.py``).

Both reduce over the example axis only, so ``[B, N, C]`` logits with
``[B, N]`` labels give one value per task.
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
