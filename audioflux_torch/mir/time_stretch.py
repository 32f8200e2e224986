"""Phase-vocoder time stretch and pitch shift.

Counterpart of ``audioflux_tpu/mir/time_stretch.py`` (reference
``src/mir/timeStretch_algorithm.c``: stft -> phase_vocoder -> weighted-OLA
istft; ``src/mir/pitchShift_algorithm.c``: time stretch by
2^(-semitone/12), then a polyphase resample back at the same ratio).  Built
on the port's ``STFT`` (the FFT kernels at pow2 2048..32768),
``phase_vocoder`` (its phase summed in float64) and ``Resample``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from audioflux_torch.dsp.phase_vocoder import phase_vocoder
from audioflux_torch.dsp.resample import Resample
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.transforms.stft import STFT
from audioflux_torch.types import ResampleQualityType, WindowType

__all__ = ["TimeStretch", "PitchShift"]


class TimeStretch:
    """API mirrors ``python/audioflux/mir/time_stretch.py``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, radix2_exp: int = 12, slide_length: int = None,
                 window_type: WindowType = WindowType.HANN, device=None):
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.slide_length = (slide_length if slide_length
                             else self.fft_length // 4)
        self.window_type = WindowType(window_type)
        self._stft = STFT(radix2_exp=radix2_exp, window_type=self.window_type,
                          slide_length=self.slide_length, device=self.device)

    def cal_data_capacity(self, rate: float, data_length: int) -> int:
        """Output buffer size the C would allocate
        (timeStretchObj_calDataCapacity, timeStretch_algorithm.c:77-80)."""
        return int(np.ceil(data_length / rate)) + self.fft_length

    def time_stretch(self, data_arr, rate: float):
        """(..., n) -> (..., ~n/rate): speed up (rate>1) / slow down."""
        if rate <= 0:
            raise ValueError("rate must be positive")
        D = self._stft.stft(data_arr)
        D2 = phase_vocoder(D, self.slide_length, rate, device=self.device)
        return self._stft.istft(D2, method_type=0)


class PitchShift:
    """API mirrors ``python/audioflux/mir/pitch_shift.py``, plus
    ``device``."""

    def __init__(self, radix2_exp: int = 12, slide_length: int = None,
                 window_type: WindowType = WindowType.HANN, device=None):
        self._ts = TimeStretch(radix2_exp, slide_length, window_type,
                               device=device)
        self.device = self._ts.device
        self._rs = Resample(ResampleQualityType.FAST, is_scale=True,
                            device=self.device)

    def pitch_shift(self, data_arr, n_semitone: int, samplate: int = 32000):
        """Shift by n_semitone (in [-12, 12]) without changing duration
        (arg order matches the reference, pitch_shift.py:79)."""
        if not -12 <= n_semitone <= 12:
            raise ValueError("n_semitone must be in [-12, 12]")
        if n_semitone == 0:
            return as_tensor(data_arr, self.device)
        rate = 2.0 ** (-n_semitone / 12.0)
        y = self._ts.time_stretch(data_arr, rate)
        # resample by ratio=rate (resampleObj_setSamplateRatio); the
        # resampler keeps one plan per (p, q, ratio)
        f = Fraction(rate).limit_denominator(1000)
        self._rs.p, self._rs.q = f.numerator, f.denominator
        self._rs.ratio = rate
        return self._rs.resample(y)
