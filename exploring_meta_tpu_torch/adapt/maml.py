"""Functional inner SGD (port of ``inner_sgd`` and ``tree_where`` from
``exploring_meta_tpu/adapt/maml.py``).

For a batch of tasks the caller passes params with a leading ``[B]`` axis
and a loss that sums the per-task mean losses: the gradient of that sum
with respect to task b's params is the gradient of task b's own loss, so
each task adapts on its own support set only.
"""

from __future__ import annotations

from typing import Callable

import torch

from exploring_meta_tpu_torch.utils.tree import (
    tree_leaves, tree_map, tree_unflatten,
)


def tree_where(mask, a, b):
    """Per-leaf select: mask leaves are booleans (or 0/1 tensors)."""
    return tree_map(
        lambda m, x, y: torch.where(torch.as_tensor(m, device=x.device), x, y),
        mask, a, b)


def inner_sgd(loss_fn: Callable, params, batch, inner_lr: float,
              adapt_steps: int, first_order: bool = False, trainable=None):
    """K steps of SGD on ``loss_fn(params, batch)`` (a scalar); returns the
    adapted params.

    ``first_order=True`` takes the inner gradients without a graph
    (``create_graph=False``), the l2l ``first_order`` flag; otherwise the
    result stays differentiable to second order. Leaves that do not
    require grad are made leaves that do, so a serving caller may pass
    plain tensors. ``trainable`` is an optional tree of bools matching
    ``params``: leaves marked False are frozen."""
    for _ in range(adapt_steps):
        params = tree_map(
            lambda v: v if v.requires_grad else v.detach().requires_grad_(),
            params)
        leaves = tree_leaves(params)
        with torch.enable_grad():
            grads = torch.autograd.grad(
                loss_fn(params, batch), leaves,
                create_graph=not first_order, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(v) if g is None else g
            for v, g in zip(leaves, grads)])
        if trainable is not None:
            grads = tree_where(trainable, grads,
                               tree_map(torch.zeros_like, grads))
        params = tree_map(lambda p, g: p - inner_lr * g, params, grads)
    return params
