"""Non-negative matrix factorization (multiplicative updates).

Counterpart of ``audioflux_tpu/classic/nmf.py`` (reference
``src/classic/nmf.c``): V ~ W@H with KL (type 0), IS (type 1) or
Euclidean (else) update rules; W is column-normalized each iteration (max
/ p1 / p2 per ``norm``); the loop stops at the first iteration where both
||dW|| and ||dH|| fall below ``thresh`` (or at ``max_iter``).  The test is
made on the host after each iteration (one device sync an iteration).

The matrix products are fp32 ``torch.matmul``: with PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` the card accumulates in
fp32 without TF32, like the reference's sgemm and the JAX package's
``Precision.HIGHEST``; the multiplicative updates iterate hundreds of times
and amplify a coarser rounding into a different local optimum.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["NMF", "nmf"]

_EPS = 1e-16


def _norm_w(W, norm: int):
    if norm == 1:
        v = torch.sum(torch.abs(W), dim=0)
    elif norm == 2:
        v = torch.sqrt(torch.sum(W * W, dim=0))
    else:
        v = torch.amax(W, dim=0)
    return W / torch.where(v == 0, torch.ones_like(v), v)


def _update(V, W, H, tp: int, norm: int):
    D = W @ H
    if tp == 0:  # KL
        R = V / (D + _EPS)
        ones = torch.ones_like(V)
        H = H * (W.T @ R) / ((W.T @ ones) + _EPS)
        W = W * (R @ H.T) / ((ones @ H.T) + _EPS)
    elif tp == 1:  # IS
        R2 = V / (D * D + _EPS)
        R1 = 1.0 / (D + _EPS)
        H = H * (W.T @ R2) / ((W.T @ R1) + _EPS)
        W = W * (R2 @ H.T) / ((R1 @ H.T) + _EPS)
    else:  # Euclidean
        H = H * (W.T @ V) / ((W.T @ D) + _EPS)
        W = W * (V @ H.T) / (((W @ H) @ H.T) + _EPS)
    return _norm_w(W, norm), H


def _nmf_impl(V, W0, H0, *, max_iter, tp, thresh, norm):
    """The update loop on V's device, the JAX ``while_loop``'s rule:
    ``W0`` is normalized, the first update always runs, and the loop goes
    on while ``i < max_iter`` and ``||dW|| >= thresh or ||dH|| >=
    thresh`` (so a NaN delta stops it, as there)."""
    Wp, Hp = _norm_w(W0, norm), H0
    W, H = _update(V, Wp, Hp, tp, norm)
    i = 1
    while i < max_iter:
        dw, dh = torch.stack([torch.linalg.norm(W - Wp),
                              torch.linalg.norm(H - Hp)]).tolist()
        if not (dw >= thresh or dh >= thresh):
            break
        Wp, Hp = W, H
        W, H = _update(V, W, H, tp, norm)
        i += 1
    return W, H


def nmf(X, k: int, w_arr=None, h_arr=None, max_iter: int = 300, tp: int = 0,
        thresh: float = 1e-3, norm: int = 0, seed: int = 0, device=None):
    """Factor X (n, m) into (W (n, k), H (k, m)), tensors on ``device``
    (``None`` means ``cuda``).

    tp: 0 KL divergence, 1 IS divergence, 2 Euclidean. Mirrors
    ``python/audioflux/classic/nmf.py``; ``W0``/``H0`` default to
    ``np.random.default_rng(seed)`` draws, the JAX package's.
    """
    dev = resolve_device(device)
    X = as_tensor(X, dev)
    n, m = X.shape
    rng = np.random.default_rng(seed)
    W0 = as_tensor(w_arr if w_arr is not None else rng.random((n, k)), dev)
    H0 = as_tensor(h_arr if h_arr is not None else rng.random((k, m)), dev)
    return _nmf_impl(X, W0, H0, max_iter=max_iter, tp=tp,
                     thresh=float(thresh), norm=norm)


class NMF:
    """Object wrapper mirroring ``python/audioflux/classic/nmf.py``, plus
    ``device``."""

    def __init__(self, k: int, max_iter: int = 300, tp: int = 0,
                 thresh: float = 1e-3, norm: int = 0, device=None):
        self.device = resolve_device(device)
        self.k = k
        self.max_iter = max_iter
        self.tp = tp
        self.thresh = thresh
        self.norm = norm

    def nmf(self, data_arr, w_arr=None, h_arr=None, seed: int = 0):
        return nmf(data_arr, self.k, w_arr, h_arr, self.max_iter, self.tp,
                   self.thresh, self.norm, seed, device=self.device)
