"""XXCC — cepstral coefficients over any filterbank spectrogram, plus the
"standard" variant (energy replace/append + delta + delta-delta).

Reference: ``src/feature/xxcc_algorithm.c`` (xxccObj_xxcc :95-156,
xxccObj_xxccStandard :168-296). The reference applies its causal
Savitzky-Golay-style delta (util_delta / filterDesign_smooth1,
flux_util.c + filterDesign_fir.c) along the *coefficient* axis of each
frame; we reproduce that exactly with a precomputed (C, C) Toeplitz matmul
instead of a per-frame FIR loop.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.transforms.spectrogram import dct_matrix, xxcc_from_spec
from audioflux_torch.types import CepstralEnergyType, CepstralRectifyType

__all__ = ["XXCC", "delta_fir_coeffs", "delta_matrix"]


def delta_fir_coeffs(order: int) -> np.ndarray:
    """The reference's smooth1 FIR taps: b[j] = (m-j)/sum(1..m of i^2),
    j=0..order-1, m=order//2 (filterDesign_fir.c: filterDesign_smooth1)."""
    if order < 3 or order % 2 == 0:
        raise ValueError("order must be odd >= 3")
    m = order // 2
    v1 = float(sum(i * i for i in range(1, m + 1)))
    return np.array([(m - j) / v1 for j in range(order)], np.float32)


def delta_matrix(length: int, order: int) -> np.ndarray:
    """(length, length) causal-FIR matrix D with y = D @ x equal to the
    reference filterDesign_filter(b, [1], x) zero-initial-condition filter."""
    b = delta_fir_coeffs(order)
    D = np.zeros((length, length), np.float32)
    for i in range(length):
        for j in range(min(order, i + 1)):
            D[i, i - j] = b[j]
    return D


class XXCC:
    """Cepstral coefficients of a (..., num, time) band spectrogram.

    API mirrors ``python/audioflux/feature/xxcc.py:61-240``; the DCT lives
    on ``device`` (``None`` -> ``cuda``).
    """

    def __init__(self, num: int, device=None):
        if num < 2:
            raise ValueError("num must be >= 2")
        self.num = int(num)
        self.device = resolve_device(device)
        self._dct = dct_matrix(self.num)
        self._dct_t = torch.from_numpy(self._dct).to(self.device)

    def set_time_length(self, time_length: int):  # compat no-op
        pass

    def xxcc(self, m_data_arr, cc_num: int = 13,
             rectify_type: CepstralRectifyType = CepstralRectifyType.LOG):
        """(..., num, T) -> (..., cc_num, T)."""
        if cc_num > self.num:
            raise ValueError(f"cc_num={cc_num} must be <= num={self.num}")
        return xxcc_from_spec(m_data_arr, self._dct_t, cc_num,
                              CepstralRectifyType(rectify_type))

    def xxcc_standard(self, m_data_arr, energy_arr, cc_num: int = 13,
                      delta_window_length: int = 9,
                      energy_type: CepstralEnergyType = CepstralEnergyType.REPLACE,
                      rectify_type: CepstralRectifyType = CepstralRectifyType.LOG):
        """Standard cepstral set: (coeffs, delta, delta-delta).

        Returns three tensors shaped (..., C, T) where C = cc_num (+1 when
        energy_type is APPEND). energy_arr: (..., T) frame energies.
        """
        if cc_num > self.num:
            raise ValueError(f"cc_num={cc_num} must be <= num={self.num}")
        d = delta_window_length
        if not (d >= 3 and d % 2 == 1):
            d = 9
        etype = CepstralEnergyType(energy_type)

        cc = self.xxcc(m_data_arr, cc_num, rectify_type).transpose(-1, -2)
        e = torch.log(torch.clamp(as_tensor(energy_arr, self.device),
                                  min=1e-8))

        if etype == CepstralEnergyType.REPLACE:
            coe = torch.cat([e[..., None], cc[..., 1:]], dim=-1)
        elif etype == CepstralEnergyType.APPEND:
            coe = torch.cat([e[..., None], cc], dim=-1)
        else:
            coe = cc

        D = torch.from_numpy(delta_matrix(coe.shape[-1], d)).to(self.device)
        d1 = torch.matmul(coe, D.T)
        d2 = torch.matmul(d1, D.T)
        return tuple(a.transpose(-1, -2).contiguous() for a in (coe, d1, d2))
