"""Conjugate gradient and damped Hessian-vector products (port of
``exploring_meta_tpu/ops/cg.py``; cherry's ``conjugate_gradient`` and
``hessian_vector_product``).

JAX runs CG as a ``lax.while_loop`` that exits once the residual is below
``tol``. Here the loop always runs ``num_iterations`` times and freezes
``x, r, p`` with ``torch.where`` once ``r.r < tol``: the same result with
no read back to the host.

A one-program seed sweep solves ``S`` systems at once on flat ``[S, P]``
vectors (JAX ``vmap``-s the solve over seeds): every dot product is per
row, and ``alpha``, ``beta`` and the ``live`` mask are ``[S, 1]``, so each
seed's solve is its own and freezes on its own residual.
"""

from __future__ import annotations

from typing import Callable

import torch

from exploring_meta_tpu_torch.utils.tree import tree_from_items, tree_items


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` of flat vectors; of ``[S, P]`` rows, ``[S, 1]``, each row's
    the very ``torch.dot`` a solo run takes (one launch a row: a batched
    reduction may sum in another order)."""
    if a.ndim == 1:
        return torch.dot(a, b)
    return torch.stack([torch.dot(x, y) for x, y in zip(a, b)]).unsqueeze(-1)


def conjugate_gradient(Ax: Callable[[torch.Tensor], torch.Tensor],
                       b: torch.Tensor, num_iterations: int = 10,
                       tol: float = 1e-10) -> torch.Tensor:
    """Solve ``A x = b`` for SPD ``A`` given ``v -> A v``; x0 = 0. ``b``
    may be ``[S, P]``: ``S`` independent systems, ``A`` block-diagonal."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rdotr = dot(r, r)
    for _ in range(num_iterations):
        live = rdotr >= tol
        ap = Ax(p)
        alpha = rdotr / dot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        new_rdotr = dot(r_new, r_new)
        p_new = r_new + (new_rdotr / rdotr) * p
        x = torch.where(live, x_new, x)
        r = torch.where(live, r_new, r)
        p = torch.where(live, p_new, p)
        rdotr = torch.where(live, new_rdotr, rdotr)
    return x


def hvp(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
        damping: float = 1e-5) -> Callable[[torch.Tensor], torch.Tensor]:
    """``v -> H v + damping * v`` for scalar ``f`` at the flat vector ``x``.

    ``grad f`` is taken once with a graph; each product is one more
    backward through it (``d(grad f . v)/dx``), which keeps that graph for
    the next call. This replaces JAX's ``jvp`` of ``grad``."""
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        (grad_f,) = torch.autograd.grad(f(x), x, create_graph=True)
    return grad_vector_product(grad_f, x, damping)


def grad_vector_product(grad_f: torch.Tensor, x: torch.Tensor,
                        damping: float, reduce=None):
    """``v -> d(grad_f . v)/dx + damping * v`` for a ``grad_f`` computed
    from ``x`` with ``create_graph=True``. For ``[S, P]`` rows whose
    function is a sum of per-row terms (a seed sweep's summed KLs) the
    Hessian is block-diagonal, so one product of the sum is every row's
    own product. ``reduce`` (a mesh's ``pmean``) averages the product over
    the ranks before the damping is added, as JAX's sharded step does."""
    def Ax(v):
        with torch.enable_grad():
            gv = (grad_f @ v.detach() if v.ndim == 1
                  else (grad_f * v.detach()).sum())
            (hv,) = torch.autograd.grad(gv, x, retain_graph=True)
        if reduce is not None:
            hv = reduce(hv)
        return hv + damping * v
    return Ax


def tree_hvp(f: Callable, params, damping: float = 1e-5):
    """Pytree version: returns ``(Ax, flat_params, unravel)`` where ``Ax``
    maps flat vectors through the damped Hessian of ``f`` at ``params``.
    The flat order is ``jax.flatten_util.ravel_pytree``'s (dict keys
    sorted), so a flat vector means the same in both packages;
    ``unravel`` maps one back to nested dicts and lists of the params'
    paths."""
    paths, leaves = zip(*tree_items(params))
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])

    def unravel(v):
        pieces = torch.split(v, sizes)
        return tree_from_items((k, p.reshape(s))
                               for k, p, s in zip(paths, pieces, shapes))

    return hvp(lambda v: f(unravel(v)), flat, damping=damping), flat, unravel
