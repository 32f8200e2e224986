"""Frame-wise harmonic ratio.

Counterpart of ``audioflux_tpu/mir/harmonic_ratio.py`` (reference
``src/mir/harmonicRatio_algorithm.c``): per window-length frame, the
normalized autocorrelation gamma(tau) = acf(tau)/sqrt(acf(0)*tailEnergy(tau))
searched past the first zero crossing of the acf, its maximum refined by
quadratic interpolation (util_qaudInterp).  The autocorrelation of every
frame, ``ifft(|fft(frame, 2 * window)|^2)`` at the lags it reads, is one
call of ``ops.cuda_fft.fft_autocorr_frames``; the cumsum tail, the
zero-crossing search and the interpolation are PyTorch on the same
device.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.mir.pitch import autocorr_rows
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import WindowType

__all__ = ["HarmonicRatio"]


def _hr_impl(x, window, *, window_length, slide_length, fft_length,
             max_length):
    frames = frame_signal(x, window_length, slide_length) * window
    acf = autocorr_rows(frames, fft_length, max_length + 1)

    csum = torch.cumsum(frames * frames, dim=-1)
    # tail[j] = cumE[window_length-2-j] (harmonicRatio_algorithm.c:186-189)
    tail = csum[..., torch.from_numpy(
        window_length - 2 - np.arange(max_length)).to(x.device)]

    # first sign change of acf in j=2..max_length -> minIndex=j-1 (:196-203)
    prev = acf[..., 1:max_length]
    cur = acf[..., 2:max_length + 1]
    cross = ((cur >= 0) & (prev <= 0)) | ((cur <= 0) & (prev >= 0))
    # argmax of an integer tensor returns the first of several equal maxima
    min_index = torch.where(cross.any(dim=-1),
                            torch.argmax(cross.to(torch.uint8), dim=-1) + 1,
                            0)

    gamma = acf[..., :max_length] / torch.sqrt(acf[..., :1] * tail + 1e-16)
    lag = torch.arange(max_length, device=x.device)
    valid = lag > min_index[..., None]
    idx = torch.argmax(torch.where(valid, gamma, -torch.inf), dim=-1)

    def take(k):
        return torch.gather(gamma, -1,
                            k.clamp(0, max_length - 1)[..., None])[..., 0]
    v1, v2, v3 = take(idx - 1), take(idx), take(idx + 1)
    # util_qaudInterp: p=(v3-v1)/(2*(2*v2-v3-v1)+1e-16); out=v2-0.25*(v1-v3)*p
    p = (v3 - v1) / (2.0 * (2.0 * v2 - v3 - v1) + 1e-16)
    interp = v2 - 0.25 * (v1 - v3) * p
    # edges use the raw maximum (:224-231): vArr1 index 0 or last
    at_edge = (idx == min_index + 1) | (idx >= max_length - 1)
    return torch.where(at_edge, v2, interp)


class HarmonicRatio:
    """API mirrors ``python/audioflux/mir/harmonic_ratio.py``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, samplate: int = 32000, low_fre: float = None,
                 radix2_exp: int = 12, slide_length: int = None,
                 window_type: WindowType = WindowType.HAMM, device=None):
        self.device = resolve_device(device)
        self.samplate = samplate
        # wrapper default is C1 = 32.7032 Hz (harmonic_ratio.py:62);
        # out-of-range values fall back to the C's internal 25 Hz
        # (harmonicRatio_algorithm.c:58)
        if low_fre is None:
            low_fre = 2.0 ** (-45 / 12.0) * 440.0  # note_to_hz('C1')
        self.low_fre = (float(low_fre)
                        if 0 < low_fre < samplate / 2 else 25.0)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << (radix2_exp + 1)
        self.window_length = self.fft_length // 2
        self.slide_length = (slide_length if slide_length
                             else self.window_length // 4)
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, self.window_length)
        self._window_t = as_tensor(self.window, self.device)
        self.max_length = min(int(np.floor(samplate / self.low_fre)),
                              self.window_length - 1)

    def cal_time_length(self, data_length: int) -> int:
        if data_length < self.window_length:
            return 0
        return (data_length - self.window_length) // self.slide_length + 1

    def harmonic_ratio(self, data_arr):
        """(..., n) -> (..., time) harmonic ratio in [0, 1]."""
        return _hr_impl(as_tensor(data_arr, self.device), self._window_t,
                        window_length=self.window_length,
                        slide_length=self.slide_length,
                        fft_length=self.fft_length,
                        max_length=self.max_length)
