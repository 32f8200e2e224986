"""Feature scalers, applied per feature column over the sample axis (axis 0).

Counterpart of ``audioflux_tpu/utils/scale.py`` on tensors (host data
becomes a CPU tensor; a tensor stays on its device).  Math follows the
reference ``src/vector/flux_vector.c`` (__v*scale) and the column-wise
application in ``python/audioflux/utils/scale.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "min_max_scale", "standard_scale", "stand_scale", "max_abs_scale",
    "robust_scale", "center_scale", "mean_scale", "arctan_scale",
]


def _t(X) -> torch.Tensor:
    return X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))


def min_max_scale(X):
    X = _t(X)
    mn = X.amin(dim=0, keepdim=True)
    mx = X.amax(dim=0, keepdim=True)
    return torch.where(mx > mn, (X - mn) / (mx - mn), X)


def standard_scale(X, tp: int = 1):
    """tp=0 sample variance (ddof=1), tp=1 population variance (ddof=0)."""
    X = _t(X)
    mean = X.mean(dim=0, keepdim=True)
    std = X.std(dim=0, keepdim=True, correction=1 - tp)
    return torch.where(std != 0, (X - mean) / std, X)


stand_scale = standard_scale  # reference naming


def max_abs_scale(X):
    X = _t(X)
    mx = X.abs().amax(dim=0, keepdim=True)
    return torch.where(mx != 0, X / mx, X)


def _quantile_ref(X, num, den):
    """Reference quantile: positional pick on the raw array
    (index (length+1)*num/den - 1; average with the next if not divisible)."""
    n = X.shape[0]
    idx = (n + 1) * num // den - 1
    mod = (n + 1) * num % den
    idx = max(idx, 0)
    if mod == 0:
        return X[idx]
    return (X[idx] + X[min(idx + 1, n - 1)]) / 2


def robust_scale(X):
    X = _t(X)
    q2 = _quantile_ref(X, 1, 2)
    q1 = _quantile_ref(X, 1, 4)
    q3 = _quantile_ref(X, 3, 4)
    # columns where q3<=q1 are never written by the C (__vrobustscale
    # guards the whole loop), so the wrapper's zero-filled output buffer
    # comes back as ZEROS there, not a passthrough
    return torch.where(q3 > q1, (X - q2) / (q3 - q1), torch.zeros_like(X))


def center_scale(X):
    X = _t(X)
    return X - X.mean(dim=0, keepdim=True)


def mean_scale(X):
    X = _t(X)
    mn = X.amin(dim=0, keepdim=True)
    mx = X.amax(dim=0, keepdim=True)
    mean = X.mean(dim=0, keepdim=True)
    return torch.where(mx > mn, (X - mean) / (mx - mn), X)


def arctan_scale(X):
    return torch.arctan(_t(X)) / (math.pi / 2)
