"""Centered Kernel Alignment, linear and RBF (port of
``exploring_meta_tpu/ops/cka.py``; reference ``utils/cka.py``). Inputs
are ``(datapoints, features)`` tensors (on any device, in their own
float dtype) or arrays; every step is a ``torch`` op on that device.

Two deviations in form, none in value: the double centering subtracts
means instead of multiplying by the centering matrix (O(n^2), not
O(n^3)), and the RBF bandwidth is the numpy (``jnp.nanmedian``) median of
the nonzero squared distances, the mean of the two middle values for an
even count. ``torch.nanmedian`` returns the lower one, so the median is
taken here as the mean of the two middle order statistics.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _center(gram: torch.Tensor) -> torch.Tensor:
    """Double-center a Gram matrix: ``H K H`` with ``H = I - 11^T/n``, as
    ``K`` less its row and column means plus its mean (O(n^2); JAX takes
    the two n x n x n products)."""
    return (gram - gram.mean(dim=0, keepdim=True)
            - gram.mean(dim=1, keepdim=True) + gram.mean())


def numpy_median(values: torch.Tensor) -> torch.Tensor | None:
    """Median with numpy's semantics (the mean of the two middle values
    for an even count) of a 1-D tensor; ``None`` when it is empty."""
    n = values.numel()
    if n == 0:
        return None
    lower = torch.kthvalue(values, (n - 1) // 2 + 1).values
    upper = torch.kthvalue(values, n // 2 + 1).values
    return (lower + upper) / 2


def _rbf_gram(x: torch.Tensor, sigma: float | None = None) -> torch.Tensor:
    gx = x @ x.T
    # pairwise squared distances d_i + d_j - 2 g_ij
    diag = torch.diagonal(gx)
    sq_dists = diag[:, None] + diag[None, :] - 2.0 * gx
    if sigma is None:
        # median-heuristic bandwidth over the nonzero distances
        med = numpy_median(sq_dists[sq_dists > 0])
        sigma_sq = 1.0 if med is None else med
    else:
        sigma_sq = float(sigma) ** 2
    return torch.exp(-0.5 * sq_dists / sigma_sq)


def _cka(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """CKA of two centered Gram matrices: HSIC(x, y) / sqrt(HSIC(x, x)
    HSIC(y, y)), each Gram computed once."""
    return torch.sum(kx * ky) / (torch.sqrt(torch.sum(kx * kx))
                                 * torch.sqrt(torch.sum(ky * ky)))


def get_linear_CKA(x, y) -> torch.Tensor:
    """Linear CKA similarity in [0, 1] (a 0-d tensor on the inputs'
    device)."""
    x, y = _as_tensor(x), _as_tensor(y)
    return _cka(_center(x @ x.T), _center(y @ y.T))


def get_kernel_CKA(x, y, sigma: float | None = None) -> torch.Tensor:
    """RBF-kernel CKA similarity (median-heuristic bandwidth by default)."""
    x, y = _as_tensor(x), _as_tensor(y)
    return _cka(_center(_rbf_gram(x, sigma)), _center(_rbf_gram(y, sigma)))
