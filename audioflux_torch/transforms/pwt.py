"""Pseudo wavelet transform — auditory-filterbank-shaped CWT.

Counterpart of ``audioflux_tpu/transforms/pwt.py`` (reference
``src/pwt_algorithm.c``): the same full-signal-FFT -> bank multiply ->
per-band inverse FFT pipeline as CWT, but the bank is a *pseudo* auditory
filterbank (real, full-fft-length grid, ``auditory_filter_bank`` with
``is_pseudo=True``, pwt_algorithm.c:315-319).  Rows stay in ascending
frequency order.  The reference has no derivative form, so ``det`` is
always off.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.filterbank.auditory import (_revise_fre,
                                                 auditory_filter_bank)
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.cuda_cwt import band_row_counts
from audioflux_torch.transforms.cwt import _cwt_conv_body, _pad_length
from audioflux_torch.types import (SpectralFilterBankNormalType,
                                   SpectralFilterBankScaleType,
                                   SpectralFilterBankStyleType)
from audioflux_torch.utils.convert import note_to_hz

__all__ = ["PWT"]


class PWT:
    """API mirrors ``python/audioflux/pwt.py:116-287``, plus ``device``
    (``None`` means ``cuda``)."""

    def __init__(self, num=84, radix2_exp=12, samplate=32000,
                 low_fre=None, high_fre=None, bin_per_octave=12,
                 scale_type=SpectralFilterBankScaleType.OCTAVE,
                 style_type=SpectralFilterBankStyleType.SLANEY,
                 normal_type=SpectralFilterBankNormalType.NONE,
                 is_padding=True, device=None):
        S = SpectralFilterBankScaleType
        scale_type = S(scale_type)
        if scale_type > S.LOG:
            raise ValueError(f"PWT does not support scale {scale_type.name}")
        data_length = 1 << radix2_exp
        if not 2 <= num <= data_length // 2 + 1:
            raise ValueError(f"num={num} out of range")
        self.device = resolve_device(device)

        log_like = scale_type in (S.OCTAVE, S.LOG)
        if low_fre is None:
            low_fre = note_to_hz("C1") if log_like else 0.0
        if high_fre is None:
            high_fre = samplate / 2.0
        if log_like and low_fre < round(note_to_hz("C1"), 3):
            raise ValueError(f"{scale_type.name} low_fre must be >= 32.703")

        if scale_type in (S.LINEAR, S.OCTAVE):
            low_fre, high_fre, _ = _revise_fre(
                scale_type, num, low_fre, high_fre, bin_per_octave,
                samplate, data_length, is_edge=True)
            if high_fre > samplate / 2.0:
                raise ValueError("lowFre and num too large, overflow")

        self.num = num
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.data_length = data_length
        self.fft_length = data_length
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.bin_per_octave = bin_per_octave
        self.scale_type = scale_type
        self.style_type = SpectralFilterBankStyleType(style_type)
        self.normal_type = SpectralFilterBankNormalType(normal_type)
        self.is_padding = bool(is_padding)
        self.pad_length = _pad_length(data_length, self.is_padding)
        w_length = data_length + 2 * self.pad_length

        fb, fre, bins = auditory_filter_bank(
            num, w_length, samplate, scale_type, self.style_type,
            self.normal_type, self.low_fre, self.high_fre, bin_per_octave,
            is_pseudo=True)
        self._bank = fb
        self.fre_band_arr = fre
        self.bin_band_arr = bins
        self._build_exec()

    def _build_exec(self):
        """Upload the bank to the plan's device and count its support rows
        (pseudo auditory banks live on the positive-frequency half, so the
        leading-run slicing of CWT applies)."""
        n = self._bank.shape[1]
        self._row_h = band_row_counts(self._bank, n) if n & (n - 1) == 0 else None
        self._row_h_t = (None if self._row_h is None else torch.tensor(
            self._row_h, dtype=torch.int32, device=self.device))
        self._bank_t = as_tensor(self._bank, self.device)

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def get_bin_band_arr(self):
        return self.bin_band_arr

    def pwt(self, data_arr):
        """(..., data_length) -> complex64 (..., num, data_length)."""
        x = as_tensor(data_arr, self.device)
        if x.shape[-1] != self.data_length:
            raise ValueError(f"data length must be exactly {self.data_length}")
        return _cwt_conv_body(x, self._bank_t, det=False,
                              pad_length=self.pad_length,
                              data_length=self.data_length,
                              row_h=self._row_h_t)

    def y_coords(self):
        return self.fre_band_arr

    def x_coords(self):
        return np.arange(self.data_length) / self.samplate
