"""Wavelet synchrosqueezed transform (CWT + squeeze in one object).

Counterpart of ``audioflux_tpu/transforms/wsst.py`` (reference
``src/wsst_algorithm.c``): instantaneous frequency from the analytic
identity Im(dCWT/CWT)/2pi (the CWT's derivative bank) instead of Synsq's
phase difference; same bin mapping and complex scatter.  Returns
(squeezed, raw cwt), both (..., num, data_length) ascending in frequency.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import as_tensor, f32_scalar
from audioflux_torch.transforms.cwt import CWT
from audioflux_torch.ops.cuda_unwrap import bin_map
from audioflux_torch.transforms.synsq import (_compose_order,
                                              _reassign_scatter, scale_kind)
from audioflux_torch.types import (SpectralFilterBankScaleType,
                                   WaveletContinueType)

__all__ = ["WSST"]


def _wsst_map(D, dD, fre_arr, *, scale_kind, num, samplate):
    """Per-cell target-bin map from the analytic instantaneous frequency
    Im(dCWT/CWT)/2pi."""
    denom = torch.where(D == 0, torch.ones_like(D), D)
    v_signed = (dD / denom).imag / f32_scalar(2 * np.pi, D.device)
    return bin_map(v_signed, fre_arr, scale_kind=scale_kind, num=num,
                   samplate=samplate)


def _squeeze(D, dD, fre_arr, *, scale_kind, num, samplate, thresh, order):
    fi = _wsst_map(D, dD, fre_arr, scale_kind=scale_kind, num=num,
                   samplate=samplate)
    fi = _compose_order(fi, num, order)
    return _reassign_scatter(D, fi, num=num, thresh=thresh)


class WSST:
    """API mirrors ``python/audioflux/wsst.py``, plus ``device`` (``None``
    means ``cuda``)."""

    def __init__(self, num=84, radix2_exp=12, samplate=32000,
                 low_fre=None, high_fre=None, bin_per_octave=12,
                 wavelet_type=WaveletContinueType.MORSE,
                 scale_type=SpectralFilterBankScaleType.OCTAVE,
                 gamma=None, beta=None, thresh=0.001, is_padding=True,
                 device=None):
        self._cwt = CWT(num=num, radix2_exp=radix2_exp, samplate=samplate,
                        low_fre=low_fre, high_fre=high_fre,
                        bin_per_octave=bin_per_octave,
                        wavelet_type=wavelet_type, scale_type=scale_type,
                        gamma=gamma, beta=beta, is_padding=is_padding,
                        device=device)
        self.device = self._cwt.device
        self.num = num
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.samplate = samplate
        self.scale_type = SpectralFilterBankScaleType(scale_type)
        self.thresh = float(thresh)
        self.order = 1

    def get_fre_band_arr(self):
        return self._cwt.get_fre_band_arr()

    def get_bin_band_arr(self):
        return self._cwt.get_bin_band_arr()

    def set_order(self, order: int):
        if order >= 1:
            self.order = int(order)

    def wsst(self, data_arr):
        """(..., 2**radix2_exp) -> (squeezed, cwt), each complex
        (..., num, data_length)."""
        D = self._cwt.cwt(data_arr)
        dD = self._cwt.cwt_det(data_arr)
        sq = _squeeze(D, dD, as_tensor(self._cwt.fre_band_arr, self.device),
                      scale_kind=scale_kind(self.scale_type), num=self.num,
                      samplate=float(self.samplate), thresh=self.thresh,
                      order=self.order)
        return sq, D

    def y_coords(self):
        return self._cwt.fre_band_arr

    def x_coords(self):
        return np.arange(self.fft_length) / self.samplate
