"""Direct matrix DCT.

Counterpart of ``audioflux_tpu/dsp/dct.py`` (reference
``src/dsp/dct_algorithm.c``): only DCT-II is implemented there (the type
enum exists but every type uses the DCT-II cosine matrix and
``dctObj_idct`` is empty); here DCT-II plus the DCT-III inverse, as fp32
matrix products.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["DCT", "dct", "idct"]


def _dct2_matrix(n: int):
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return np.cos(np.pi * (j + 0.5) * i / n).astype(np.float32)


def _norm_scale(n: int):
    s = np.full(n, np.sqrt(2.0 / n), np.float32)
    s[0] = np.sqrt(1.0 / n)
    return s


def dct(data_arr, is_norm: bool = False, device=None):
    """DCT-II over the last axis (dctObj_dct)."""
    dev = resolve_device(device)
    x = as_tensor(data_arr, dev)
    n = x.shape[-1]
    out = torch.matmul(x, as_tensor(_dct2_matrix(n), dev).T)
    if is_norm:
        out = out * as_tensor(_norm_scale(n), dev)
    return out


def idct(data_arr, is_norm: bool = False, device=None):
    """DCT-III (inverse of the DCT-II above)."""
    dev = resolve_device(device)
    x = as_tensor(data_arr, dev)
    n = x.shape[-1]
    m = as_tensor(_dct2_matrix(n), dev)
    if is_norm:
        return torch.matmul(x * as_tensor(_norm_scale(n), dev), m)
    half = x.clone()
    half[..., 0] *= 0.5
    return torch.matmul(half, m) * (2.0 / n)


class DCT:
    """Object API mirroring ``dctObj_*``, plus ``device`` (``None`` means
    ``cuda``)."""

    def __init__(self, length: int, dct_type: int = 0, device=None):
        self.device = resolve_device(device)
        self.length = length
        self.dct_type = dct_type

    def dct(self, data_arr, is_norm: bool = False):
        return dct(data_arr, is_norm, device=self.device)

    def idct(self, data_arr, is_norm: bool = False):
        return idct(data_arr, is_norm, device=self.device)
