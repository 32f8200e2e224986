"""BFT ("Based Fourier Transform"): the v2 spectrogram front-end.

Counterpart of ``audioflux_tpu/transforms/bft.py`` (reference
``src/bft_algorithm.c``): an (optionally reassigned) STFT followed by a
filterbank projection.  Complex results keep phase (POWER squares the
complex value, bft_algorithm.c:457-470); real results go power/mag (+norm)
then through the filterbank (:488-530).  LINEAR scale is a bin slice
[low_index, high_index] rather than a product (:472-486).  Optional
temporal side data (energy/rms/zcr) mirrors bftObj_getTemporalData.

Matrix products run in full fp32 (TF32 stays off), the counterpart of the
TPU package's ``Precision.HIGHEST``.  ``bft_fused`` runs the fused CUDA
kernel of ``ops.fused_mel``.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.filterbank.auditory import auditory_filter_bank
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.fused_mel import FusedMelPlan, fused_mel_mfcc
from audioflux_torch.transforms.reassign import Reassign
from audioflux_torch.transforms.spectrogram import dct_matrix
from audioflux_torch.transforms.temporal import Temporal
from audioflux_torch.types import (ReassignType, SpectralDataType,
                                   SpectralFilterBankNormalType,
                                   SpectralFilterBankScaleType,
                                   SpectralFilterBankStyleType, WindowType)

__all__ = ["BFT"]


class BFT:
    """API mirrors ``python/audioflux/bft.py:142-509``, plus ``device``
    (``None`` means ``cuda``)."""

    def __init__(self, num, radix2_exp=12, samplate=32000,
                 low_fre=None, high_fre=None, bin_per_octave=12,
                 window_type=WindowType.HANN,
                 slide_length=None,
                 scale_type=SpectralFilterBankScaleType.LINEAR,
                 style_type=SpectralFilterBankStyleType.SLANEY,
                 normal_type=SpectralFilterBankNormalType.NONE,
                 data_type=SpectralDataType.MAG,
                 is_reassign=False, is_temporal=False, device=None):
        S = SpectralFilterBankScaleType
        scale = S(scale_type)
        if scale > S.LOG:
            raise ValueError(f"BFT does not support scale {scale.name}")
        fft_length = 1 << radix2_exp
        if num > fft_length // 2 + 1:
            raise ValueError(f"num={num} is too large")
        self.device = resolve_device(device)

        log_like = scale in (S.OCTAVE, S.LOG)
        # defaults (bft_algorithm.c:155-190): log scales span A-45..A+38
        if low_fre is None:
            low_fre = (2.0 ** (-45 / 12.0) * 440.0) if log_like else 0.0
        if high_fre is None:
            high_fre = ((2.0 ** (38 / 12.0) * 440.0) if log_like
                        else samplate / 2.0)
        if high_fre < low_fre:
            low_fre = (2.0 ** (-45 / 12.0) * 440.0) if log_like else 0.0
            high_fre = ((2.0 ** (38 / 12.0) * 440.0) if log_like
                        else samplate / 2.0)

        low_index = high_index = 0
        if scale == S.LINEAR:
            # reviseLinearFre isEdge=1 (bft_algorithm.c:143-151)
            det = samplate / float(fft_length)
            low_index = int(np.round(np.float32(low_fre) / np.float32(det)))
            high_index = low_index + num - 1
            low_fre = low_index * det
            high_fre = high_index * det
            if high_fre > samplate / 2.0:
                raise ValueError("scale linear: lowFre and num too large")

        self.num = int(num)
        self.radix2_exp = radix2_exp
        self.fft_length = fft_length
        self.samplate = samplate
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.bin_per_octave = bin_per_octave
        self.window_type = WindowType(window_type)
        self.slide_length = slide_length if slide_length else fft_length // 4
        self.scale_type = scale
        self.style_type = SpectralFilterBankStyleType(style_type)
        self.normal_type = SpectralFilterBankNormalType(normal_type)
        self.data_type = SpectralDataType(data_type)
        self.is_reassign = bool(is_reassign)
        self.is_temporal = bool(is_temporal)
        self.low_index = low_index
        self.high_index = high_index
        self.result_type = 0
        self.norm_value = 1.0

        self._re = Reassign(
            radix2_exp=radix2_exp, samplate=samplate,
            window_type=self.window_type, slide_length=self.slide_length,
            re_type=(ReassignType.ALL if self.is_reassign
                     else ReassignType.NONE), device=self.device)

        if scale == S.LINEAR:
            det = samplate / float(fft_length)
            self.filter_bank = None
            self.fre_band_arr = (np.arange(low_index, high_index + 1) * det
                                 ).astype(np.float32)
            self.bin_band_arr = np.arange(low_index, high_index + 1,
                                          dtype=np.int32)
        else:
            fb, fre, bins = auditory_filter_bank(
                num, fft_length, samplate, scale, self.style_type,
                self.normal_type, self.low_fre, self.high_fre,
                bin_per_octave)
            self.filter_bank = fb
            self.fre_band_arr = fre
            self.bin_band_arr = bins

        self._temp = (Temporal(frame_length=fft_length,
                               slide_length=self.slide_length,
                               window_type=self.window_type,
                               device=self.device)
                      if self.is_temporal else None)
        self._build_exec()

    def _build_exec(self):
        """Upload the filterbank to the plan's device (the window lives in
        the inner ``Reassign`` plan) and drop the fused path's plans."""
        self._fb_t = (None if self.filter_bank is None
                      else as_tensor(self.filter_bank, self.device))
        self._fused_cache = {}

    # ------------------------------------------------------------------
    def cal_time_length(self, data_length: int) -> int:
        return self._re.cal_time_length(data_length)

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def get_bin_band_arr(self):
        return self.bin_band_arr

    def set_result_type(self, result_type: int):
        if result_type not in (0, 1):
            raise ValueError("result_type must be 0 or 1")
        self.result_type = result_type

    def set_data_norm_value(self, norm_value: float):
        if norm_value > 0:
            self.norm_value = float(norm_value)

    # ------------------------------------------------------------------
    def bft(self, data_arr, result_type: int = None):
        """(..., n) -> (..., num, time); complex64 when result_type 0."""
        if result_type is not None:
            self.set_result_type(result_type)
        x = as_tensor(data_arr, self.device)
        D = self._re.reassign(x, result_type=0).transpose(-1, -2)  # (.., T, m)
        out = self._project(D, self.result_type, self.norm_value)
        if self._temp is not None:
            self._temp.temporal(x)
        return out

    def _project(self, D, rt, norm_value):
        S = SpectralFilterBankScaleType
        lin = slice(self.low_index, self.high_index + 1)
        if rt == 0:  # complex result
            if self.data_type == SpectralDataType.POWER:
                re, im = D.real, D.imag
                D = torch.complex(re * re - im * im, 2 * re * im)
            if self.scale_type == S.LINEAR:
                out = D[..., lin]
            else:
                out = torch.complex(torch.matmul(D.real, self._fb_t.T),
                                    torch.matmul(D.imag, self._fb_t.T))
        else:  # real result
            P = D.real.square() + D.imag.square()
            if self.data_type == SpectralDataType.MAG:
                P = P.sqrt()
            elif norm_value != 1:
                P = P.pow(norm_value)
            if self.scale_type == S.LINEAR:
                out = P[..., lin]
            else:
                out = torch.matmul(P, self._fb_t.T)
            if self.data_type == SpectralDataType.MAG and norm_value != 1:
                out = out.pow(norm_value)
        return out.transpose(-1, -2).contiguous()

    def bft_fused(self, data_arr, cc_num: int = 13, tile: int = 200):
        """Bulk throughput path through the fused kernel
        (``ops.fused_mel``): frame -> window -> DFT -> power -> filterbank
        -> log-DCT, with only the audio and the two outputs in device
        memory.

        Requires the plain real/POWER configuration (POWER data, norm 1,
        no reassign).  LINEAR scale runs with an exact 0/1 bin-selection
        bank.  Any frame count works; ``tile`` (the TPU kernel's frame
        tile; the CUDA kernel sizes its own) is accepted for call
        compatibility.  ``cc_num=0`` returns an empty cepstrum.  Returns
        (spec (..., num, T), cc (..., cc_num, T)).
        """
        if (self.data_type != SpectralDataType.POWER
                or self.norm_value != 1 or self.is_reassign):
            raise ValueError("bft_fused needs POWER data, norm 1 and no "
                             "reassign; use .bft()")
        cc_rows = max(cc_num, 1)  # the kernel's plan needs one DCT row
        plan = self._fused_cache.get(cc_rows)
        if plan is None:
            fb = self.filter_bank
            if fb is None:  # LINEAR: selection of bins low..high (exact)
                fb = np.zeros((self.num, self.fft_length // 2 + 1),
                              np.float32)
                fb[np.arange(self.num),
                   self.low_index + np.arange(self.num)] = 1.0
            plan = FusedMelPlan(self._re._wins[0], fb,
                                dct_matrix(self.num)[:cc_rows],
                                self.slide_length, device=self.device)
            self._fused_cache[cc_rows] = plan
        spec, cc = fused_mel_mfcc(plan, data_arr)
        return spec, cc[..., :cc_num, :]

    def get_temporal_data(self):
        if self._temp is None:
            raise RuntimeError("BFT was created with is_temporal=False")
        e, r, z, _ = self._temp.get_data()
        return e, r, z

    # ------------------------------------------------------------------
    def y_coords(self):
        return self.fre_band_arr

    def x_coords(self, data_length: int):
        T = self.cal_time_length(data_length)
        return np.arange(T) * self.slide_length / self.samplate
