"""Harmonic/percussive source separation (median-filter + Wiener masks).

Counterpart of ``audioflux_tpu/mir/hpss.py`` (reference
``src/mir/hpss_algorithm.c``): STFT (hamm) -> magnitude -> median filter
along time (h_order) and frequency (p_order) -> soft masks h^2/(h^2+p^2)
-> resynthesis (:193-330).  One code path for both devices: for a CUDA
tensor at pow2 2048 <= fft_length <= 32768 the transforms are the FFT
kernels and the medians the median kernel; elsewhere ``ops.fft`` and the
kernels' plain versions take their place.  ``HPSSNMF`` is not ported yet.
"""

from __future__ import annotations

import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.cuda_median import median_filter_last_axis
from audioflux_torch.ops.frame import (cal_data_length, cal_time_length,
                                       frame_signal)
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.transforms.stft import _ola_frames
from audioflux_torch.types import WindowType

__all__ = ["HPSS"]


def _hpss_impl(x, window, *, fft_length, slide_length, h_order, p_order):
    frames = frame_signal(x, fft_length, slide_length)
    m = fft_length // 2 + 1
    # the full hermitian spectrum, natural bin order
    Z = afft.fft(frames * window, dim=-1)               # (..., T, n)
    mag = Z[..., :m].abs().contiguous()                 # (..., T, m)

    # the time-axis median runs on the inner axis in place (no transposes)
    h = median_filter_last_axis(mag, h_order, dim=-2)
    p = median_filter_last_axis(mag, p_order, dim=-1)
    h2, p2 = h * h, p * p
    denom = torch.clamp(h2 + p2, min=1e-16)

    # real Wiener masks applied directly to the full spectrum.  The masks
    # are hermitian-symmetric (M[n-k] = M[k]), so both extend to all n
    # bins by a mirror and BOTH resyntheses run as ONE inverse transform:
    # ifft((Mh + i*Mp) * X) = h_frames + i*p_frames.
    def mirror(M):
        return torch.cat([M, M[..., 1:m - 1].flip(-1)], dim=-1)

    masks = torch.complex(mirror(h2 / denom), mirror(p2 / denom))
    y = _ola_frames(afft.ifft(masks * Z, dim=-1), window,
                    fft_length=fft_length, slide_length=slide_length,
                    method_type=0)
    return y.real, y.imag


class HPSS:
    """API mirrors ``python/audioflux/mir/hpss.py:99-230``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, radix2_exp: int = 12,
                 window_type: WindowType = WindowType.HAMM,
                 slide_length: int = 1024, h_order: int = 21,
                 p_order: int = 31, device=None):
        if h_order < 1 or h_order % 2 == 0 or p_order < 1 or p_order % 2 == 0:
            raise ValueError("h_order/p_order must be odd positive")
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.window_type = WindowType(window_type)
        self.slide_length = slide_length if slide_length else self.fft_length // 4
        self.h_order = h_order
        self.p_order = p_order
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._build_exec()

    def _build_exec(self):
        """Upload the window to the plan's device."""
        self._window_t = as_tensor(self.window, self.device)

    def cal_time_length(self, data_length: int) -> int:
        return cal_time_length(data_length, self.fft_length, self.slide_length)

    def cal_data_length(self, data_length: int) -> int:
        """Output length for ``data_length`` input samples
        (hpssObj_calDataLength, hpss_algorithm.c:96-111: frames the input
        then (T-1)*slide + fft)."""
        if data_length < self.fft_length:
            return 0
        return cal_data_length(self.cal_time_length(data_length),
                               self.fft_length, self.slide_length)

    def hpss(self, data_arr):
        """(..., n) -> (harmonic, percussive), each (..., out_n)."""
        return _hpss_impl(as_tensor(data_arr, self.device), self._window_t,
                          fft_length=self.fft_length,
                          slide_length=self.slide_length,
                          h_order=self.h_order, p_order=self.p_order)
