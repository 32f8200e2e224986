"""Deconv: spectrum deconvolution into timbre (formant) and pitch residue.

Counterpart of ``audioflux_tpu/features/deconv.py`` (reference
``src/feature/deconv_algorithm.c:106-161``): per frame, the band vector is
zero-padded to L = ceil_pow2(2*num) and transformed; the cepstral
magnitude |F| goes back to the timbre component, and F/|F| (the whitened
spectrum) to the pitch component.  The per-frame loop is one batched
transform over a (..., T, L) tile (``ops.fft``: the FFT kernels for a CUDA
tensor at L >= 2048).
"""

from __future__ import annotations

import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["Deconv"]


def _ceil_pow2(n: int) -> int:
    L = 1
    while L < n:
        L <<= 1
    return L


class Deconv:
    """API mirrors ``python/audioflux/feature/deconv.py:65-138``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, num: int, device=None):
        if num < 2:
            raise ValueError("num must be >= 2")
        self.device = resolve_device(device)
        self.num = int(num)
        self._L = _ceil_pow2(2 * self.num)

    def set_time_length(self, time_length: int):  # compat no-op
        pass

    def deconv(self, m_data_arr):
        """(..., num, T) mag/power spectrogram -> (timbre, pitch), each
        (..., num, T)."""
        num, L = self.num, self._L
        x = as_tensor(m_data_arr, self.device).transpose(-1, -2)
        F = afft.fft(x, n=L, dim=-1)
        mag = F.abs()
        timbre = afft.ifft(mag, dim=-1).real[..., :num]
        white = F / torch.clamp(mag, min=1e-16)
        pitch = afft.ifft(white, dim=-1).real[..., :num]
        return (timbre.transpose(-1, -2).contiguous(),
                pitch.transpose(-1, -2).contiguous())
