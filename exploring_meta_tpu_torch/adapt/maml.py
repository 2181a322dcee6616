"""MAML/ANIL engine: functional inner loop and the meta-step (port of
``exploring_meta_tpu/adapt/maml.py``).

For a batch of tasks the task axis is written out where JAX used
``vmap``: a task batch is ``[B, ...]``, params shared by the tasks are
expanded to per-task ``[B, ...]`` copies (:func:`per_task`), and the inner
loss is the sum of the per-task mean losses. The gradient of that sum
with respect to task b's params is the gradient of task b's own loss, so
each task adapts on its own support set only; autograd sums the per-task
meta-gradients back into the shared leaves.

A ``fast_adapt(params, *task_batch) -> TaskResult`` takes the shared
params and a task batch and returns per-task ``[B]`` query losses and
metrics. :func:`make_meta_step` differentiates their mean and takes an
Adam step (:func:`adam`, ``torch.optim.Adam`` with ``optax.adam``'s
defaults).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from exploring_meta_tpu_torch.parallel.multiseed import (
    seed_draws, seed_means, seeded,
)
from exploring_meta_tpu_torch.utils.graphs import FusedIterations, bind_once
from exploring_meta_tpu_torch.utils.tree import (
    tree_leaves, tree_map, tree_unflatten,
)


def tree_where(mask, a, b):
    """Per-leaf select: mask leaves are Python bools (a whole leaf is taken,
    with no host-to-device copy of the flag) or boolean tensors."""
    return tree_map(
        lambda m, x, y: (x if m else y) if isinstance(m, bool)
        else torch.where(m, x, y), mask, a, b)


def per_task(params, B: int):
    """Shared params -> ``[B, ...]`` copies, one per task (or request)."""
    return tree_map(lambda t: t.unsqueeze(0).expand((B,) + tuple(t.shape))
                    .contiguous(), params)


def task_copies(params, n_tasks: int, seeds: int | None = None):
    """Per-task copies of a run's params for ``n_tasks`` tasks:
    :func:`per_task` of shared params, or, for ``seeds`` seeds' stacked
    ``[S, ...]`` params, each seed's copied to its ``n_tasks // S`` tasks
    (``parallel/multiseed.py:seeded``)."""
    if seeds is None:
        return per_task(params, n_tasks)
    return seeded(params, n_tasks // seeds)


def inner_sgd(loss_fn: Callable, params, batch, inner_lr: float,
              adapt_steps: int, first_order: bool = False, trainable=None):
    """K steps of SGD on ``loss_fn(params, batch)`` (a scalar); returns the
    adapted params.

    ``first_order=True`` takes the inner gradients without a graph
    (``create_graph=False``), the l2l ``first_order`` flag; otherwise the
    result stays differentiable to second order. Under ``torch.no_grad()``
    nothing can differentiate the result, so the gradients are taken
    without a graph too: the adapted values are the same. Leaves that do
    not require grad are made leaves that do, so a serving caller may pass
    plain tensors. ``trainable`` is an optional tree of bools matching
    ``params``: leaves marked False are frozen."""
    create_graph = not first_order and torch.is_grad_enabled()
    for _ in range(adapt_steps):
        params = tree_map(
            lambda v: v if v.requires_grad else v.detach().requires_grad_(),
            params)
        leaves = tree_leaves(params)
        with torch.enable_grad():
            grads = torch.autograd.grad(
                loss_fn(params, batch), leaves,
                create_graph=create_graph, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(v) if g is None else g
            for v, g in zip(leaves, grads)])
        if trainable is not None:
            grads = tree_where(trainable, grads,
                               tree_map(torch.zeros_like, grads))
        params = tree_map(lambda p, g: p - inner_lr * g, params, grads)
    return params


class TaskResult(NamedTuple):
    loss: torch.Tensor    # [B] query losses, differentiable
    metric: torch.Tensor  # [B] accuracy (vision) or reward (RL)


def make_fast_adapt(loss_and_metric: Callable, inner_lr: float,
                    adapt_steps: int, first_order: bool = False,
                    trainable=None):
    """Build ``fast_adapt`` (reference ``core_functions/vision.py:6-18``):
    adapt on the support set, evaluate on the query set.

    ``loss_and_metric(params, batch) -> (loss [B], metric [B])`` on a task
    batch. Returns ``fast_adapt(params, support, query) -> TaskResult``,
    where ``params`` are per task (``[B, ...]``, :func:`per_task`)."""
    def support_loss(p, b):
        return loss_and_metric(p, b)[0].sum()

    def fast_adapt(params, support, query) -> TaskResult:
        adapted = inner_sgd(support_loss, params, support, inner_lr,
                            adapt_steps, first_order=first_order,
                            trainable=trainable)
        loss, metric = loss_and_metric(adapted, query)
        return TaskResult(loss=loss, metric=metric)

    return fast_adapt


def cast_compute(fast_adapt: Callable, dtype=torch.bfloat16):
    """Mixed precision: run the whole per-task graph (inner loops and the
    second-order backward) in ``dtype`` while the params and the optimizer
    state stay float32 master copies.

    The cast happens inside the differentiated function, so autograd
    carries the meta-gradients back to the float32 leaves. The returned
    TaskResult is cast back to float32."""

    def cast(tree):
        return tree_map(lambda x: x.to(dtype)
                        if torch.is_floating_point(x) else x, tree)

    def fa(params, *batch) -> TaskResult:
        res = fast_adapt(cast(params), *cast(list(batch)))
        return TaskResult(loss=res.loss.float(), metric=res.metric.float())

    return fa


def adam(params, lr: float) -> torch.optim.Adam:
    """The outer optimizer: ``torch.optim.Adam`` over the tree's leaves
    with ``optax.adam``'s defaults (b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root, as torch does). It is the opt state that
    :func:`make_meta_step` carries; the leaves must be leaf tensors that
    require grad, and each step updates them in place. On the card it is
    ``capturable``: its step count lives on the device, so a step can be
    captured in a CUDA graph (``--fuse``), and every step, eager or
    replayed, runs the same device arithmetic."""
    leaves = tree_leaves(params)
    if not all(t.is_leaf and t.requires_grad for t in leaves):
        raise ValueError("adam: every param must be a leaf tensor that "
                         "requires grad")
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=leaves[0].device.type == "cuda")


def apply_meta_gradient(opt: torch.optim.Adam, loss: torch.Tensor,
                        params, reduce=None) -> None:
    """Differentiate ``loss`` with respect to the leaves of ``params`` (a
    leaf it does not reach gets a zero gradient) and step ``opt`` (from
    :func:`adam`), which updates them in place. The gradients are written
    into each leaf's ``.grad`` where it has one, so they stay at the
    addresses that a captured step reads. ``reduce`` (a mesh's
    ``pmean_``) averages the gradients over the ranks in place before the
    step, so every rank steps the same."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            if p.grad is None:
                p.grad = torch.zeros_like(p) if g is None else g
            elif g is None:
                p.grad.zero_()
            else:
                p.grad.copy_(g)
    if reduce is not None:
        reduce([p.grad for p in leaves])
    opt.step()


def _batch_loss(fast_adapt, params, task_batch, seeds=None):
    res = fast_adapt(params, *task_batch)
    return seed_means(res.loss, seeds), seed_means(res.metric, seeds)


def make_meta_step(fast_adapt: Callable, seeds: int | None = None,
                   mesh=None):
    """Build the outer step: ``meta_step(params, opt, *task_batch) ->
    (params, opt, {"loss", "metric"})``.

    The mean query loss over the task batch (the reference's grad
    accumulation and ``p.grad.mul_(1/B)``, ``vision/maml_vision.py:139-
    141``) is differentiated through everything and ``opt`` (from
    :func:`adam`) steps the params in place; the returned metrics are
    detached scalars on the device (no host sync).

    ``seeds``: ``fast_adapt`` takes ``S`` seeds' stacked params and a task
    batch of ``S·B`` tasks, seed-major (``parallel/multiseed.py``); the
    loss differentiated is the sum over seeds of each seed's mean query
    loss (the seeds' params are disjoint, so each seed's gradient is its
    own) and the metrics are ``[S]``.

    ``mesh`` (``parallel/mesh.py``): the task batch is this rank's shard;
    the gradients of its mean loss and the metrics are averaged over the
    ranks (equal shards: the global means), and every rank steps the
    same."""

    def meta_step(params, opt, *task_batch):
        loss, metric = _batch_loss(fast_adapt, params, task_batch, seeds)
        apply_meta_gradient(opt, loss if seeds is None else loss.sum(),
                            params,
                            reduce=None if mesh is None else mesh.pmean_)
        loss, metric = loss.detach(), metric.detach()
        if mesh is not None:
            loss, metric = mesh.pmean(loss, metric)
        return params, opt, {"loss": loss, "metric": metric}

    return meta_step


def make_meta_eval(fast_adapt: Callable, seeds: int | None = None,
                   mesh=None):
    """Meta-evaluation over a task batch, no outer update (reference
    ``core_functions/vision.py:26-42``): ``meta_eval(params, *task_batch)
    -> {"loss", "metric"}`` (``[S]`` each with ``seeds``, as
    :func:`make_meta_step`).

    It runs ``fast_adapt`` under ``torch.no_grad()``: the inner loop then
    adapts first order (:func:`inner_sgd`) and the query pass builds no
    graph. The adapted params, and so the loss and metric, are the same as
    with a second-order graph, which nothing here would differentiate.
    ``mesh``: the batch is this rank's shard and the metrics are averaged
    over the ranks."""

    def meta_eval(params, *task_batch):
        with torch.no_grad():
            loss, metric = _batch_loss(fast_adapt, params, task_batch, seeds)
        if mesh is not None:
            loss, metric = mesh.pmean(loss, metric)
        return {"loss": loss, "metric": metric}

    return meta_eval


def make_train_scan(fast_adapt: Callable, sample_fn: Callable, n_steps: int,
                    eval_sample_fn: Callable | None = None,
                    seeds: int | None = None, mesh=None):
    """``n_steps`` whole meta-iterations in one call (the port of the JAX
    ``lax.scan``): on the card the first iteration runs eagerly, then one
    iteration is captured as a CUDA graph and each later one is a replay;
    on the CPU each runs eagerly (``utils/graphs.py:FusedIterations``). No
    host sync inside.

    ``sample_fn(gen) -> task_batch`` draws each step's training batch;
    ``eval_sample_fn(gen)``, if given, a validation batch, which is
    meta-evaluated on the step's pre-update params (the reference's valid
    pass runs before ``opt.step()``, ``vision/maml_vision.py:117-141``) and
    adds ``valid_loss`` / ``valid_metric``.

    Returns ``train(params, opt, gen, n=n_steps) -> (params, opt,
    metrics)``, ``n <= n_steps`` iterations with each metric stacked
    ``[n]``; the params are stepped in place. ``train`` is bound to the
    params, optimizer and generator of its first call.

    ``seeds``: the one-program sweep of ``S`` seeds (JAX's ``vmap_seeds``
    of this scan): ``fast_adapt`` is built with ``seeds=S``, ``params``
    are stacked ``[S, ...]``, ``gen`` is the tuple of the seeds'
    generators, each seed's batches are drawn from its own generator as
    its solo run draws them and concatenated, and each metric is ``[n,
    S]``. Every kernel runs once an iteration for all seeds.

    ``mesh`` (JAX's ``make_sharded_train_scan``): ``gen`` is this rank's
    generator (``parallel/mesh.py:rank_generator``), ``sample_fn`` and
    ``eval_sample_fn`` draw this rank's share of the tasks, and the
    gradients and metrics are averaged over the ranks; on the card the
    collectives are captured in the graph (NCCL only)."""
    meta_step = make_meta_step(fast_adapt, seeds, mesh)
    meta_eval = make_meta_eval(fast_adapt, seeds, mesh)

    def make(params, opt, *gens):
        if mesh is not None:
            from exploring_meta_tpu_torch.parallel.mesh import check_fusable
            check_fusable(mesh, gens[0].device)
        gen = gens[0] if seeds is None else gens

        def step():
            batch = seed_draws(sample_fn, gen, seeds)
            row = {}
            if eval_sample_fn is not None:
                valid = meta_eval(params,
                                  *seed_draws(eval_sample_fn, gen, seeds))
                row = {"valid_loss": valid["loss"],
                       "valid_metric": valid["metric"]}
            _, _, out = meta_step(params, opt, *batch)
            return {**out, **row}
        return FusedIterations(step, n_steps, gens[0].device, gens,
                               metric_shape=() if seeds is None
                               else (seeds,))

    loop = bind_once(make)

    def train(params, opt, gen, n=None):
        gens = (gen,) if seeds is None else tuple(gen)
        return params, opt, loop(params, opt, *gens)(n)

    train.fused = loop     # its FusedIterations: train.fused.bound()
    return train
