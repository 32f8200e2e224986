"""Analytic signal via FFT (Hilbert transform).

Counterpart of ``audioflux_tpu/dsp/hilbert.py`` (reference
``src/dsp/hilbert_algorithm.c``): mask [1, 2..2, 1, 0..0] on the spectrum,
inverse transform back; the real part is the input, the imaginary part its
Hilbert transform.  Both transforms go through ``ops.fft`` (the FFT
kernels on the card at lengths 2048..32768).
"""

from __future__ import annotations

import functools

import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["Hilbert", "hilbert"]


@functools.lru_cache(maxsize=16)
def _mask(L: int, device: torch.device) -> torch.Tensor:
    h = torch.zeros(L, dtype=torch.float32, device=device)
    h[0] = 1.0
    h[L // 2] = 1.0
    h[1:L // 2] = 2.0
    return h


def hilbert(data_arr, fft_length: int = None, device=None):
    """(..., n) -> complex analytic signal (..., fft_length or n)."""
    dev = resolve_device(device)
    x = as_tensor(data_arr, dev)
    L = fft_length or x.shape[-1]
    F = afft.fft(x, n=L, dim=-1)
    return afft.ifft(F * _mask(L, dev), dim=-1)


class Hilbert:
    """Object API mirroring ``hilbertObj_*``, plus ``device`` (``None``
    means ``cuda``)."""

    def __init__(self, radix2_exp: int = 12, device=None):
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp

    def hilbert(self, data_arr):
        return hilbert(data_arr, self.fft_length, device=self.device)
