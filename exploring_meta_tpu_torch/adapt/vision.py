"""Few-shot vision fast-adapt: MAML and ANIL on CNN4 backbones (port of
``exploring_meta_tpu/adapt/vision.py``).

A task batch arrives as ``(data [B, 2*shots*ways, H, W, C], labels [B,
2*shots*ways])`` in class-major order; the even/odd interleave split of
``tasks/sampler.py:split_support_query`` is applied inside (even indices
are the support set).

ANIL keeps the reference's details: the body encodes each task's support
and query images jointly before the split (so BN statistics see both), the
inner loop adapts only the head on those features, and the feature graph
is kept, so the second-order meta-gradient reaches the body through the
inner head update.
"""

from __future__ import annotations

from typing import Callable

from exploring_meta_tpu_torch.adapt.maml import (
    TaskResult, inner_sgd, make_fast_adapt, task_copies,
)
from exploring_meta_tpu_torch.models.cnn4 import (
    CNN4Spec, cnn4_apply, cnn4_features, cnn4_head_apply,
)
from exploring_meta_tpu_torch.ops.losses import accuracy, cross_entropy
from exploring_meta_tpu_torch.tasks.sampler import split_support_query


def make_vision_fast_adapt(spec: CNN4Spec, inner_lr: float, adapt_steps: int,
                           shots: int, ways: int, anil: bool = False,
                           first_order: bool = False,
                           remat_body: bool = False,
                           seeds: int | None = None) -> Callable:
    """-> ``fast_adapt(params, data, labels) -> TaskResult`` (``[B]`` loss
    and accuracy) for a task batch; ``params`` are shared by the tasks.

    ``remat_body`` (ANIL only): checkpoint each body conv block
    (``torch.utils.checkpoint``), trading FLOPs for memory.

    ``seeds``: ``params`` are ``S`` seeds' stacked ``[S, ...]`` params and
    the batch holds ``S·B`` tasks, seed-major; each task runs on its seed's
    params (``adapt/maml.py:task_copies``), the CNN4 kernels once for all
    ``S·B`` tasks. BN statistics are per task either way."""

    if not anil:
        def loss_and_metric(params, batch):
            x, y = batch
            logits = cnn4_apply(params, spec, x)
            return cross_entropy(logits, y), accuracy(logits, y)

        adapt_eval = make_fast_adapt(loss_and_metric, inner_lr, adapt_steps,
                                     first_order=first_order)

        def fast_adapt(params, data, labels) -> TaskResult:
            support, query = split_support_query(data, labels, shots, ways)
            return adapt_eval(task_copies(params, data.shape[0], seeds),
                              support, query)

        return fast_adapt

    def head_loss(head, batch):
        f, y = batch
        return cross_entropy(cnn4_head_apply({"head": head}, f), y).sum()

    def fast_adapt_anil(params, data, labels) -> TaskResult:
        # Encode the whole task batch once with the (inner-frozen) body;
        # seeds' bodies are per task (their own seed's)
        body = params if seeds is None else task_copies(
            {"base": params["base"]}, data.shape[0], seeds)
        feats = cnn4_features(body, spec, data, remat=remat_body)
        (f_s, y_s), (f_q, y_q) = split_support_query(feats, labels, shots,
                                                     ways)
        head = inner_sgd(head_loss,
                         task_copies(params["head"], data.shape[0], seeds),
                         (f_s, y_s), inner_lr, adapt_steps,
                         first_order=first_order)
        logits = cnn4_head_apply({"head": head}, f_q)
        return TaskResult(loss=cross_entropy(logits, y_q),
                          metric=accuracy(logits, y_q))

    return fast_adapt_anil
