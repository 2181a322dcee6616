"""Faults planted in the program under test, to show that the check
catches them: each patches the package for as long as its context lasts,
before the cell's driver builds anything.

- ``unchanged``: a training step returns its state unchanged.
- ``half_batch``: half of the batch is left out (training: the loss is
  the mean over the first half of the tasks; serving: the second half of
  a bucket is answered with the first half's answers).
- ``answer``: every served answer is altered where it is produced (each
  request gets the next request's answer).
- ``one_slot``: one slot of every served bucket is answered with the next
  slot's answer; the others are right.
- ``lr``: training's Adam steps with a learning rate a third too large.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half_batch", "answer", "one_slot", "lr")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _rows(tree, fn):
    from exploring_meta_tpu_torch.utils.tree import tree_map
    return tree_map(fn, tree)


def _served(fault: str, orig, n_batched: int):
    """A server's per-bucket function with ``fault``: after the params,
    its first ``n_batched`` arguments are batched along their first axis
    (a Trajectory too); any after them pass through."""
    def call(self, params, *args):
        xs, rest = args[:n_batched], args[n_batched:]
        if fault == "answer":
            return _rows(orig(self, params, *args), lambda t: t.roll(1, 0))
        if fault == "one_slot":
            def swap(t):
                k = t.shape[0] // 3
                return torch.cat([t[:k], t[k + 1:k + 2], t[k + 1:]])
            return _rows(orig(self, params, *args), swap)
        lead = xs[0].reward if hasattr(xs[0], "reward") else xs[0]
        half = lead.shape[0] // 2
        out = orig(self, params, *_rows(xs, lambda t: t[:half]), *rest)
        return _rows(out, lambda t: torch.cat([t, t]))
    return call


def plant(kind: str, driver: str):
    """-> a context manager that plants fault ``kind`` for ``driver``."""
    if kind not in KINDS:
        raise ValueError(kind)
    if driver in ("vision_serve", "rl_serve"):
        from exploring_meta_tpu_torch import serve
        cls, name = ((serve.VisionServer, "_serve") if driver ==
                     "vision_serve" else (serve.PolicyServer, "_adapt"))
        n_batched = 3 if driver == "vision_serve" else 1
        return _patched(cls, name, _served(kind, getattr(cls, name),
                                           n_batched))
    if driver == "vision_train":
        from exploring_meta_tpu_torch.adapt import maml
        if kind == "unchanged":
            return _patched(maml, "apply_meta_gradient",
                            lambda opt, loss, params, reduce=None: None)
        if kind == "lr":
            adam = maml.adam
            return _patched(maml, "adam",
                            lambda params, lr: adam(params, lr * 4 / 3))
        orig = maml._batch_loss

        def half(fast_adapt, params, task_batch, seeds=None):
            h = task_batch[0].shape[0] // 2
            return orig(fast_adapt, params, [t[:h] for t in task_batch],
                        seeds)
        return _patched(maml, "_batch_loss", half)
    raise ValueError(driver)
