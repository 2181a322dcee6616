"""SVCCA: canonical correlation similarity between activation matrices
(port of ``exploring_meta_tpu/ops/cca.py``; reference ``utils/cca.py``,
called as ``get_cca_similarity(A, B, epsilon)[1]``, the mean correlation
coefficient).

The covariance of the stacked activations (the large product) runs on the
tensors' device in float32 with TF32 off, as ``jnp.cov`` at the JAX
package's highest precision; the pruning, the inverse square roots
(eigh) and the SVD of the whitened cross-covariance run in float64 numpy
on the host, as in JAX: the matrices are only (neurons, neurons) and the
decompositions are precision-critical.

Activations are ``(num_neurons, num_datapoints)`` with ``num_neurons <
num_datapoints``, as in the reference: tensors (on any device) or arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def _cov_f32(stacked: torch.Tensor) -> np.ndarray:
    """``torch.cov`` (correction 1, rows are variables) in float32 with
    TF32 off, whatever the process's matmul precision -> float64 numpy."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cov = torch.cov(stacked)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return cov.double().cpu().numpy()


def _inv_sqrt_psd(mat: np.ndarray) -> np.ndarray:
    """Inverse matrix square root of a PSD matrix via eigendecomposition,
    zeroing tiny eigenvalues like ``np.linalg.pinv``."""
    w, v = np.linalg.eigh(mat)
    cutoff = np.max(np.abs(w)) * mat.shape[0] * np.finfo(mat.dtype).eps
    inv_sqrt_w = np.where(w > cutoff, 1.0 / np.sqrt(np.maximum(w, cutoff)), 0.0)
    return (v * inv_sqrt_w[None, :]) @ v.T


def get_cca_similarity(acts1, acts2, epsilon: float = 0.0,
                       threshold: float = 0.98):
    """CCA similarity of two activation sets -> ``(info_dict, mean_cca)``
    like the reference API. ``info_dict`` holds ``cca_coef1`` (all
    coefficients), ``mean`` (thresholded mean, 2-tuple), ``sum`` and the
    pruning masks ``x_idxs`` / ``y_idxs``."""
    acts1 = _as_f32(acts1)
    acts2 = _as_f32(acts2, device=acts1.device)
    if acts1.shape[1] != acts2.shape[1]:
        raise AssertionError("datapoint counts must match")
    if acts1.shape[0] >= acts1.shape[1]:
        raise AssertionError("inputs must be (neurons, datapoints)")
    return cca_from_cov(_cov_f32(torch.cat([acts1, acts2], dim=0)),
                        acts1.shape[0], epsilon=epsilon, threshold=threshold)


def cca_from_cov(cov: np.ndarray, nx: int, epsilon: float = 0.0,
                 threshold: float = 0.98):
    """The host half of :func:`get_cca_similarity`, in float64: from the
    covariance of the stacked activations (the first ``nx`` rows are the
    first set's) to ``(info_dict, mean_cca)``."""
    cov = np.asarray(cov, dtype=np.float64)
    sxx, sxy = cov[:nx, :nx], cov[:nx, nx:]
    syy = cov[nx:, nx:]

    # Rescale for numerical stability, then drop near-dead directions.
    xmax = np.max(np.abs(sxx))
    ymax = np.max(np.abs(syy))
    sxx = sxx / xmax
    syy = syy / ymax
    sxy = sxy / np.sqrt(xmax * ymax)

    x_keep = np.abs(np.diagonal(sxx)) >= epsilon
    y_keep = np.abs(np.diagonal(syy)) >= epsilon
    if not x_keep.any() or not y_keep.any():
        zeros = np.zeros((min(nx, cov.shape[0] - nx),))
        info = {"cca_coef1": zeros, "cca_coef2": zeros,
                "mean": (0.0, 0.0), "sum": (0.0, 0.0),
                "x_idxs": x_keep, "y_idxs": y_keep}
        return info, 0.0

    sxx = sxx[np.ix_(x_keep, x_keep)]
    syy = syy[np.ix_(y_keep, y_keep)]
    sxy = sxy[np.ix_(x_keep, y_keep)]

    sxx = sxx + epsilon * np.eye(sxx.shape[0], dtype=sxx.dtype)
    syy = syy + epsilon * np.eye(syy.shape[0], dtype=syy.dtype)

    whitened = _inv_sqrt_psd(sxx) @ sxy @ _inv_sqrt_psd(syy)
    s = np.abs(np.linalg.svd(whitened, compute_uv=False))

    # Mean over the leading coefficients that carry `threshold` of the mass.
    cumulative = np.cumsum(s)
    idx = int(np.searchsorted(cumulative, cumulative[-1] * threshold)) + 1
    idx = max(1, min(idx, s.shape[0]))

    info = {
        "cca_coef1": s,
        "cca_coef2": s,
        "mean": (float(np.mean(s[:idx])), float(np.mean(s[:idx]))),
        "sum": (float(np.sum(s)), float(np.sum(s))),
        "x_idxs": x_keep,
        "y_idxs": y_keep,
    }
    return info, float(np.mean(s))


def robust_cca_similarity(acts1, acts2, epsilon: float = 1e-6,
                          threshold: float = 0.98, num_trials: int = 5):
    """Retry CCA with added jitter if a decomposition fails (reference
    ``utils/cca.py:365-413``). The jitter is JAX's numpy stream, added on
    the activations' device."""
    rng = np.random.default_rng(0)
    a1 = _as_f32(acts1)
    a2 = _as_f32(acts2, device=a1.device)
    for trial in range(num_trials):
        try:
            return get_cca_similarity(a1, a2, epsilon=epsilon,
                                      threshold=threshold)
        except np.linalg.LinAlgError:
            # only numerical failures are retried; misuse such as a wrong
            # orientation surfaces at once
            if trial + 1 == num_trials:
                raise
            a1 = a1 * 1e-1 + torch.as_tensor(
                rng.normal(size=tuple(a1.shape)), dtype=a1.dtype,
                device=a1.device) * epsilon
            a2 = a2 * 1e-1 + torch.as_tensor(
                rng.normal(size=tuple(a2.shape)), dtype=a2.dtype,
                device=a2.device) * epsilon
