"""User-facing doubly-stochastic graph metric.

Counterpart of `fsw_gnn_tpu/utils/dsmetric.py`: takes numpy arrays (or
tensors), returns a float (and optionally the optimized S as numpy).  Runs
the Sinkhorn / mirror-descent solver of `ops.sinkhorn` on `device` (None:
the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.sinkhorn import dsmetric_solve


def dsmetric(A1, V1, A2, V2, lambda_features=1.0, use_squared_dists=False,
             return_S=False, n_outer=500, dtype=torch.float32, device=None):
    n, d = np.shape(V1)
    n2, d2 = np.shape(V2)
    if n != n2:
        raise ValueError('Graph sizes (number of nodes) must match.')
    if d != d2:
        raise ValueError('Feature dimensions must match.')
    out = dsmetric_solve(A1, V1, A2, V2, lambda_features=lambda_features,
                         use_squared_dists=use_squared_dists,
                         n_outer=n_outer, return_S=return_S, device=device,
                         dtype=dtype)
    if return_S:
        obj, S = out
        return float(obj), S.cpu().numpy()
    return float(out)
