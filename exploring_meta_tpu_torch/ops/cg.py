"""Conjugate gradient and damped Hessian-vector products (port of
``exploring_meta_tpu/ops/cg.py``; cherry's ``conjugate_gradient`` and
``hessian_vector_product``).

JAX runs CG as a ``lax.while_loop`` that exits once the residual is below
``tol``. Here the loop always runs ``num_iterations`` times and freezes
``x, r, p`` with ``torch.where`` once ``r.r < tol``: the same result with
no read back to the host.
"""

from __future__ import annotations

from typing import Callable

import torch


def conjugate_gradient(Ax: Callable[[torch.Tensor], torch.Tensor],
                       b: torch.Tensor, num_iterations: int = 10,
                       tol: float = 1e-10) -> torch.Tensor:
    """Solve ``A x = b`` for SPD ``A`` given ``v -> A v``; x0 = 0."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rdotr = torch.dot(r, r)
    for _ in range(num_iterations):
        live = rdotr >= tol
        ap = Ax(p)
        alpha = rdotr / torch.dot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        new_rdotr = torch.dot(r_new, r_new)
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
                        damping: float):
    """``v -> d(grad_f . v)/dx + damping * v`` for a ``grad_f`` computed
    from ``x`` with ``create_graph=True``."""
    def Ax(v):
        with torch.enable_grad():
            (hv,) = torch.autograd.grad(grad_f @ v.detach(), x,
                                        retain_graph=True)
        return hv + damping * v
    return Ax
