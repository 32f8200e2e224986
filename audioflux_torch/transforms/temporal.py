"""Temporal features: frame-wise energy, RMS and zero-cross rate (+ EZR).

Counterpart of ``audioflux_tpu/transforms/temporal.py`` (reference
``src/temporal_algorithm.c``): frames of ``frame_length`` every
``slide_length`` samples are windowed, then energy = sum(x^2),
rms = sqrt(energy/N), zcr = sign-change count / N
(flux_vector.c:1765-1789); ezr = log10(1+E*gamma)/(zcr*N+1)
(temporal_algorithm.c:temporalObj_ezr).  Batched over leading dims.
"""

from __future__ import annotations

import torch

from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import WindowType

__all__ = ["Temporal"]


class Temporal:
    """API mirrors ``python/audioflux/temporal.py:60-298``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, frame_length: int = 2048, slide_length: int = 512,
                 window_type: WindowType = WindowType.HANN, device=None):
        self.device = resolve_device(device)
        self.frame_length = int(frame_length)
        self.slide_length = int(slide_length)
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, self.frame_length)
        self._window_t = as_tensor(self.window, self.device)
        self._frames = None  # windowed frames of the last temporal() call

    def cal_time_length(self, data_length: int) -> int:
        if data_length < self.frame_length:
            return 0
        return (data_length - self.frame_length) // self.slide_length + 1

    def temporal(self, data_arr, has_energy: bool = False,
                 has_rms: bool = False, has_zcr: bool = False,
                 has_m: bool = False):
        """Energy/rms/zero-cross features of (..., n) audio.

        With any ``has_*`` flag set, returns the reference's feature dict
        (``temporal.py:94``: keys ``energy_arr``/``rms_arr``/``zcr_arr``/
        ``m_arr``).  With no flags, returns the (energy, rms, zcr) tuple;
        results are also kept for :meth:`get_data` and :meth:`ezr`.
        """
        x = as_tensor(data_arr, self.device)
        fw = frame_signal(x, self.frame_length, self.slide_length) \
            * self._window_t
        energy = (fw * fw).sum(dim=-1)
        rms = torch.sqrt(energy / self.frame_length)
        sign_change = (fw[..., 1:] * fw[..., :-1] < 0).to(torch.float32)
        zcr = sign_change.sum(dim=-1) / self.frame_length
        self._frames = fw
        self._energy, self._rms, self._zcr = energy, rms, zcr
        if not (has_energy or has_rms or has_zcr or has_m):
            return energy, rms, zcr
        dic = {}
        if has_energy:
            dic["energy_arr"] = energy
        if has_rms:
            dic["rms_arr"] = rms
        if has_zcr:
            dic["zcr_arr"] = zcr
        if has_m:
            dic["m_arr"] = fw
        return dic

    def get_data(self, data_arr=None):
        """(energy, rms, zcr, windowed frame matrix (..., T, frame_length)),
        computed from ``data_arr`` or kept from the last :meth:`temporal`
        call."""
        if data_arr is not None:
            self.temporal(data_arr)
        if self._frames is None:
            raise RuntimeError("call temporal() first")
        return self._energy, self._rms, self._zcr, self._frames

    def ezr(self, gamma: float = 1.0):
        """Energy/zero-cross ratio of the kept frames."""
        if self._frames is None:
            raise RuntimeError("call temporal() first")
        v1 = torch.log10(1.0 + self._energy * gamma)
        v2 = self._zcr * self.frame_length + 1.0
        return v1 / v2
