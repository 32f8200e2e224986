"""Chirp-Z transform (zoom spectrum) via Bluestein's algorithm.

Counterpart of ``audioflux_tpu/dsp/czt.py`` (reference
``src/dsp/czt_algorithm.c``): zoom over normalized frequencies [low_w,
high_w] with A = exp(j*2pi*low_w), W = exp(-j*2pi*(high_w-low_w)/N).  (The
reference C reads 2N samples from an N-sample Python buffer, a latent
overread; this implementation uses the intended N-point input.)  The
transforms at the power of 2 L >= n+m-1 go through ``ops.fft`` (the FFT
kernels on the card at lengths 2048..32768); the chirps are built in
float64 on the host once per shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import resolve_device
from audioflux_torch.transforms.stft import _as_complex

__all__ = ["CZT", "czt"]


@functools.lru_cache(maxsize=16)
def _chirps(n: int, m: int, L: int, low_w: float, high_w: float,
            device: torch.device):
    """(pre-chirp (n,), FFT of the chirp filter (L,), post-chirp (m,))."""
    w_step = (high_w - low_w) / m
    k = np.arange(max(n, m), dtype=np.float64)
    wk2 = np.exp(-1j * 2 * np.pi * w_step * (k * k) / 2)  # W^(k^2/2)
    a_k = np.exp(-1j * 2 * np.pi * low_w * np.arange(n))
    h = np.zeros(L, np.complex128)
    h[:m] = np.conj(wk2[:m])
    h[L - n + 1:] = np.conj(wk2[1:n][::-1])
    return tuple(torch.from_numpy(v.astype(np.complex64)).to(device)
                 for v in (a_k * wk2[:n], np.fft.fft(h), wk2[:m]))


def czt(data_arr, low_w: float, high_w: float, out_length: int = None,
        device=None):
    """Zoom DFT of (..., n) over [low_w, high_w] (normalized to samplate).

    Returns complex64 (..., out_length) with out_length defaulting to n:
    X[k] = sum_n x[n] * exp(-j*2pi*(low_w + k*(high_w-low_w)/out)*n).
    """
    dev = resolve_device(device)
    x = _as_complex(data_arr, dev)
    n = x.shape[-1]
    m = out_length or n
    L = 1
    while L < n + m - 1:
        L <<= 1
    pre, Fh, post = _chirps(n, m, L, float(low_w), float(high_w), dev)
    Fg = afft.fft(x * pre, n=L, dim=-1)
    return afft.ifft(Fg * Fh, dim=-1)[..., :m] * post


class CZT:
    """API mirrors ``python/audioflux/dsp/czt.py``, plus ``device``
    (``None`` means ``cuda``)."""

    def __init__(self, radix2_exp: int = 12, device=None):
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp

    def czt(self, data_arr, low_w: float, high_w: float):
        if not (0 <= low_w < high_w <= 1):
            raise ValueError("require 0 <= low_w < high_w <= 1")
        return czt(data_arr, low_w, high_w, device=self.device)
