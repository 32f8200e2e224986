"""Discrete-wavelet filter coefficient tables.

Counterpart of ``audioflux_tpu/filterbank/dwt.py``.  Loaded from this
package's own ``data/dwt_coef.npz`` (standard published constants — haar,
db2-40, sym2-30, coif1-5, fk4-22, bior1.1-6.8, dmey — the same tables
PyWavelets ships), a byte-identical copy of the TPU package's table.
Mirrors ``dwt_filterCoef`` (src/filterbank/dwt_filterCoef.h).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from audioflux_torch.types import WaveletDiscreteType

__all__ = ["wavelet_coef", "wavelet_name"]


@functools.lru_cache(maxsize=1)
def _load():
    path = os.path.join(os.path.dirname(__file__), "data", "dwt_coef.npz")
    with np.load(path) as data:
        return dict(data)


def wavelet_name(wavelet_type, t1: int = 4, t2: int = 0) -> str:
    W = WaveletDiscreteType(wavelet_type)
    if W == WaveletDiscreteType.HAAR:
        return "haar"
    if W == WaveletDiscreteType.DB:
        return f"db{t1}"
    if W == WaveletDiscreteType.SYM:
        return f"sym{t1}"
    if W == WaveletDiscreteType.COIF:
        return f"coif{t1}"
    if W == WaveletDiscreteType.FK:
        return f"fk{t1}"
    if W == WaveletDiscreteType.BIOR:
        return f"bior{t1}.{t2}"
    if W == WaveletDiscreteType.DMEY:
        return "dmey"
    raise ValueError(f"unsupported wavelet {wavelet_type!r}")


def wavelet_coef(wavelet_type, t1: int = 4, t2: int = 0,
                 coef_type: int = 0):
    """(lo, hi) float32 filters; coef_type 0 decomposition, 1 reconstruction."""
    name = wavelet_name(wavelet_type, t1, t2)
    data = _load()
    tag = "d" if coef_type == 0 else "r"
    key = f"{name}_lo_{tag}"
    if key not in data:
        raise ValueError(f"unsupported wavelet spec {name}")
    return data[key].copy(), data[f"{name}_hi_{tag}"].copy()
