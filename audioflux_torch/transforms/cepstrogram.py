"""Cepstrogram: per-frame cepstrum matrix with envelope/details liftering.

Counterpart of ``audioflux_tpu/transforms/cepstrogram.py`` (reference
``src/cepstrogram_algorithm.c``): STFT (default rect window) -> power ->
log(max(p,1e-16)) -> IFFT = real cepstrum; the envelope keeps quefrencies
[0..cep_num] (mirrored symmetrically) and transforms back, the details
keep the complementary band.  The per-frame loops (:131-199) are batched
transforms over the (..., T, fft) tile.

All three transforms are ``exact=True``, the TPU package's rule for
log-cepstral consumers (see ``ops/fft.py``): they run ``torch.fft``, and
this module launches no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import cal_time_length, frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import WindowType

__all__ = ["Cepstrogram"]


class Cepstrogram:
    """API mirrors ``python/audioflux/cepstrogram.py:83-227``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, radix2_exp: int = 12, samplate: int = 32000,
                 window_type: WindowType = WindowType.RECT,
                 slide_length: int = 1024, device=None):
        if not 1 <= radix2_exp <= 30:
            raise ValueError("radix2_exp must be in [1, 30]")
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.fft_length = 1 << radix2_exp
        self.window_type = WindowType(window_type)
        self.slide_length = (slide_length if slide_length > 0
                             else self.fft_length // 4)
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._build_exec()

    def _build_exec(self):
        self._window_t = as_tensor(self.window, self.device)

    def cal_time_length(self, data_length: int) -> int:
        return cal_time_length(data_length, self.fft_length, self.slide_length)

    def cepstrogram(self, data_arr, cep_num: int = 4):
        """(..., n) -> (cepstrums, envelope, details), each
        (..., fft_length//2+1, time)."""
        if not 4 <= cep_num <= 128:
            raise ValueError("cep_num must be in [4, 128]")
        L = self.fft_length
        m = L // 2 + 1
        x = as_tensor(data_arr, self.device)
        frames = frame_signal(x, L, self.slide_length)
        spec = afft.fft(frames * self._window_t, dim=-1, exact=True)
        logp = torch.log(torch.clamp(spec.abs() ** 2, min=1e-16))
        ceps = afft.ifft(logp, dim=-1, exact=True).real      # (..., T, L)

        # envelope: keep [0..cep], mirror [1..cep] into the tail
        # (cepstrogram_algorithm.c:160-168)
        env_mask = np.zeros((L,), np.float32)
        env_mask[:cep_num + 1] = 1.0
        env_mask[L - cep_num:] = 1.0  # tail j: arr[L-j-1] = arr[j+1]
        envelope = afft.fft(ceps * as_tensor(env_mask, self.device), dim=-1,
                            exact=True).real[..., :m]

        # details: keep [cep+1 .. L-cep] (the complementary copy length is
        # fftLength-2*cep_num, cepstrogram_algorithm.c:184-186)
        det_mask = np.zeros((L,), np.float32)
        det_mask[cep_num + 1:cep_num + 1 + (L - 2 * cep_num)] = 1.0
        details = afft.fft(ceps * as_tensor(det_mask, self.device), dim=-1,
                           exact=True).real[..., :m]

        return tuple(a.transpose(-1, -2).contiguous()
                     for a in (ceps[..., :m], envelope, details))

    def y_coords(self):
        return np.linspace(0, self.samplate / 2, self.fft_length // 2 + 1)

    def x_coords(self, data_length: int):
        T = self.cal_time_length(data_length)
        return np.arange(T) * self.slide_length / self.samplate
