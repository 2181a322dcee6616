"""Continual-learning transfer metrics from an N x N accuracy matrix (port
of ``exploring_meta_tpu/ops/cl_metrics.py``; reference
``utils/cl_metrics.py``, the metrics of "Don't forget, there is more than
forgetting", Diaz-Rodriguez et al.).

``acc_matrix[i, j]`` is the performance on task j after adapting on task
i. Host numpy in float64: the matrix is tiny and the analysis is offline.
"""

from __future__ import annotations

import numpy as np


def calc_cl_metrics(acc_matrix) -> dict:
    """Average accuracy, forward/backward transfer, remembering, BWT+."""
    acc_matrix = np.asarray(acc_matrix, dtype=np.float64)
    n = acc_matrix.shape[0]

    # Average accuracy: diagonal + lower triangle, normalized by n(n+1)/2.
    av_acc = np.tril(acc_matrix, k=0).sum() / (n * (n + 1) / 2)

    # Forward transfer: strict upper triangle, normalized by n(n-1)/2.
    pair_count = n * (n - 1) / 2
    fwt = np.triu(acc_matrix, k=1).sum() / pair_count

    # Backward transfer: the reference sums acc[i, j] - acc[j, j] over all
    # (i >= 1, j <= n-2) pairs.
    bwt = sum(acc_matrix[i, j] - acc_matrix[j, j]
              for i in range(1, n) for j in range(n - 1)) / pair_count

    rem = 1.0 - abs(min(bwt, 0.0))
    bwt_plus = max(bwt, 0.0)

    return dict(av_acc=av_acc, fwt=fwt, rem=rem, bwt_plus=bwt_plus)
