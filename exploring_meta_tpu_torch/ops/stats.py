"""Small statistical helpers mirroring ``cherry`` utilities (port of
``exploring_meta_tpu/ops/stats.py``)."""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """``(x - mean) / (std + eps)`` with Bessel-corrected std, as
    ``ch.normalize`` (reference ``core_functions/rl.py:278,355``). A tensor
    of at most one element passes through unchanged, as cherry's does."""
    if x.numel() <= 1:
        return x
    return (x - x.mean()) / (x.std(correction=1) + epsilon)


def onehot(x, dim: int) -> torch.Tensor:
    """Integer states -> one-hot float32 rows ``[numel, dim]``
    (``ch.onehot``, reference ``core_functions/policies.py:263``)."""
    flat = torch.as_tensor(x).to(torch.int64).reshape(-1)
    return (flat[:, None] == torch.arange(dim, device=flat.device)[None, :]
            ).to(torch.float32)
