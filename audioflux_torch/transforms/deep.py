"""Deep / DeepChroma spectrograms: salience-peak pitch-class projection.

Counterpart of ``audioflux_tpu/transforms/deep.py`` (reference
``src/spectrogram_algorithm.c`` DEEP path, :1230-1258 exec, :1683-1840
__spectrogramObj_deepFilter): per frame, local maxima of the magnitude
spectrum above adaptive thresholds (max >= 13, floor max/10 clipped at 2)
are frequency-corrected (hamm peak correction), snapped to the nearest
MIDI tone, and max-scattered onto a midi-bin grid; DEEP keeps the peak's
left/right neighbour amplitudes as extra channels, DEEP_CHROMA folds the
midi grid into 12 pitch classes (chroma_cqtFilterBank) and normalizes.

The forward transform at L is ``ops.fft.rfft`` (the FFT kernel on the
card at L in 2048..32768).  The TPU package models the C's per-peak loop
with a one-hot (..., T, m, num) score tensor; here every step stays at
(..., T, m), the spectrum's own size, with the same result value for
value:

* a slot's amplitude is the max of its peaks (a max-scatter);
* a peak *improves* its slot when it is strictly above every earlier peak
  of the slot.  The peaks of a frame are sorted by slot (stably, so
  spectrum order holds within a slot) and a running max over a key of
  (slot, amplitude bits) gives each peak the max of the earlier peaks of
  its slot;
* a channel keeps the value of the LAST improving peak that wrote it (a
  max-scatter of the peaks' spectrum indices, then a gather).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.filterbank import scales as _sc
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.correct import correct_fn
from audioflux_torch.ops.frame import cal_time_length, frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.transforms.cqt import chroma_cqt_filter_bank
from audioflux_torch.transforms.spectrogram import chroma_normalize
from audioflux_torch.types import (ChromaDataNormalType, SpectralDataType,
                                   WindowType)
from audioflux_torch.utils.convert import note_to_hz

__all__ = ["DeepSpectrogram", "DeepChromaSpectrogram"]


def _improving(vals, tgt, n_slots):
    """Per cell, whether it is strictly above every earlier cell (in
    spectrum order) of its slot ``tgt``; cells of the trash slot
    ``n_slots`` never are.  ``vals`` >= 0."""
    skey, order = torch.sort(tgt, dim=-1, stable=True)
    bits = vals.gather(-1, order).view(torch.int32).to(torch.int64)
    # nonnegative floats order as their bit patterns: one running max of
    # (slot, bits) is a running max within each slot
    run = torch.cummax((skey << 32) | bits, dim=-1).values
    prev = F.pad(run[..., :-1], (1, 0), value=-1)
    prev_bits = torch.where((prev >> 32) == skey, prev & 0xFFFFFFFF, 0)
    imp = (bits > prev_bits) & (skey < n_slots)
    return torch.zeros_like(imp).scatter_(-1, order, imp)


class _DeepBase:
    def __init__(self, num, samplate, radix2_exp, low_fre, high_fre,
                 window_type, slide_length, data_type, device):
        fft_length = 1 << radix2_exp
        if low_fre is None:
            low_fre = note_to_hz("C1")
        if high_fre is None:
            high_fre = 16000.0
        window_type = WindowType(window_type)
        if window_type > WindowType.HAMM:
            window_type = WindowType.HAMM

        self.device = resolve_device(device)
        self.samplate = samplate
        self.radix2_exp = radix2_exp
        self.fft_length = fft_length
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.window_type = window_type
        self.slide_length = slide_length if slide_length else fft_length // 4
        self.data_type = SpectralDataType(data_type)
        self.window = get_fft_window(window_type, fft_length)
        self.norm_value = 1.0
        self.chroma_data_normal_type = ChromaDataNormalType.MAX

        # salience thresholds (spectrogram_algorithm.c:568-571)
        self.max_min = 13.0
        self.min_max = 2.0
        self.ratio = 10.0
        self.deep_order = 1  # spectrogram_algorithm.c:563

        det = samplate / float(fft_length)
        self.start_index = int(np.floor(self.low_fre / det))
        self.end_index = min(int(np.ceil(self.high_fre / det)),
                             fft_length // 2)

        # base grid: midi tones starting at log-snapped low_fre (:calDeepBandArr)
        base_log = float(_sc.hz_to_log(self.low_fre, 12))
        self.base_fre = float(_sc.log_to_hz(base_log, 12))
        self.midi_start = int(np.round(12 * np.log2(self.base_fre / 440.0)
                                       + 69))

    def _build_exec(self):
        self._window_t = as_tensor(self.window, self.device)

    def cal_time_length(self, data_length: int) -> int:
        return cal_time_length(data_length, self.fft_length,
                               self.slide_length)

    def set_deep_order(self, deep_order: int):
        """Neighbour-channel layout (spectrogramObj_setDeepOrder,
        spectrogram_algorithm.c:829-834): 1/2 -> 3 channels
        [amp, left1, right1] (1 keeps only the louder side per peak),
        3/4 -> 5 channels adding [left2, right2] (3 keeps the louder
        second neighbour)."""
        if deep_order not in (1, 2, 3, 4):
            raise ValueError(f"deep_order={deep_order} must be in [1,4]")
        self.deep_order = int(deep_order)

    def _deep_amps(self, data_arr, base_num):
        """(..., n) -> (amp, chans): amp (..., T, base_num) and the
        neighbour channels, each (..., T, base_num)."""
        x = as_tensor(data_arr, self.device)
        frames = frame_signal(x, self.fft_length, self.slide_length)
        mag = afft.rfft(frames * self._window_t, dim=-1).abs()  # (..., T, m)
        m = mag.shape[-1]
        s, e = self.start_index, self.end_index

        mx = mag[..., s:e + 1].amax(dim=-1, keepdim=True)
        floor = torch.clamp(mx / self.ratio, min=self.min_max)
        frame_ok = mx >= self.max_min

        # local maxima in (max(s,1), min(e, m-2))
        left = F.pad(mag[..., :-1], (1, 0))
        right = F.pad(mag[..., 1:], (0, 1))
        j = torch.arange(m, device=mag.device)
        in_range = (j >= max(s, 1)) & (j <= min(e, m - 2))
        is_peak = ((mag > left) & (mag > right) & in_range
                   & (mag >= floor) & frame_ok)

        det, _ = correct_fn(self.window_type)(mag, left, right)
        correct_fre = (j + det) * (self.samplate / float(self.fft_length))
        # nearest midi tone by Hz distance (_calTone)
        safe_fre = torch.clamp(correct_fre, min=1e-6)
        fi = torch.floor(12 * torch.log2(safe_fre / 440.0) + 69.0)
        fv = torch.pow(2.0, (fi - 69.0) / 12.0) * 440.0
        cv = torch.pow(2.0, (fi + 1.0 - 69.0) / 12.0) * 440.0
        midi = torch.where((safe_fre - fv).abs() < (safe_fre - cv).abs(),
                           fi, fi + 1.0)
        deep_idx = (midi - self.midi_start).to(torch.int32)
        ok = is_peak & (deep_idx >= 0) & (deep_idx < base_num)
        tgt = torch.where(ok, deep_idx, base_num).to(torch.int64)  # trash
        vals = torch.where(ok, mag, 0.0)
        slots = mag.shape[:-1] + (base_num + 1,)
        amp = vals.new_zeros(slots).scatter_reduce_(
            -1, tgt, vals, "amax")[..., :base_num]
        improving = _improving(vals, tgt, base_num)
        del vals

        def last_where(val, mask=None):
            """val at the LAST spectrum index of an improving peak of each
            slot (where ``mask`` holds, if given); 0 where there is none."""
            sel = improving if mask is None else improving & mask
            pos = torch.full(slots, -1, dtype=torch.int64,
                             device=mag.device).scatter_reduce_(
                -1, tgt, torch.where(sel, j, -1), "amax")[..., :base_num]
            got = val.gather(-1, pos.clamp(min=0))
            return torch.where(pos >= 0, got, 0.0)

        order = self.deep_order
        if order == 1:  # louder first neighbour only, per improving peak
            chans = [last_where(left, left > right),
                     last_where(right, left <= right)]
        else:
            chans = [last_where(left), last_where(right)]
        if order >= 3:
            # second neighbours: OOB reads stay 0, and a second neighbour
            # louder than its first is zeroed (non-peak-shaped shoulder)
            l2 = F.pad(mag[..., :-2], (2, 0))
            r2 = F.pad(mag[..., 2:], (0, 2))
            l2 = torch.where(l2 > left, 0.0, l2)
            r2 = torch.where(r2 > right, 0.0, r2)
            if order == 3:  # louder second neighbour only
                chans += [last_where(l2, l2 > r2), last_where(r2, l2 <= r2)]
            else:
                chans += [last_where(l2), last_where(r2)]
        return amp, chans


class DeepSpectrogram(_DeepBase):
    """DEEP scale (``python/audioflux/spectrogram.py:2655`` `Deep`):
    (..., 3, num, time) channels [peak amp, left neighbour, right
    neighbour]; plus ``device`` (``None`` means ``cuda``)."""

    def __init__(self, num=84, samplate=32000, radix2_exp=12,
                 low_fre=None, high_fre=None,
                 window_type=WindowType.HAMM, slide_length=None,
                 data_type=SpectralDataType.POWER, device=None):
        super().__init__(num, samplate, radix2_exp, low_fre, high_fre,
                         window_type, slide_length, data_type, device)
        self.num = num
        self.base_num = num
        logs = np.arange(num) + float(_sc.hz_to_log(self.low_fre, 12))
        self.fre_band_arr = np.asarray(_sc.log_to_hz(logs, 12), np.float32)
        det = samplate / float(self.fft_length)
        self.bin_band_arr = np.round(self.fre_band_arr / det).astype(np.int32)
        self._build_exec()

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def spectrogram(self, data_arr):
        amp, chans = self._deep_amps(data_arr, self.base_num)
        out = torch.stack([amp] + chans, dim=-3)  # (..., 3|5, T, num)
        if self.data_type == SpectralDataType.POWER:
            out = out * out
        if self.norm_value != 1:
            out = torch.pow(out, self.norm_value)
        return out.transpose(-1, -2).contiguous()  # (..., 3|5, num, T)


class DeepChromaSpectrogram(_DeepBase):
    """DEEP_CHROMA scale (``python/audioflux/spectrogram.py:2739``
    `DeepChroma`): chroma fold of the deep amplitude grid; plus
    ``device``."""

    def __init__(self, samplate=32000, radix2_exp=12, num=12,
                 low_fre=None, high_fre=None,
                 window_type=WindowType.HAMM, slide_length=None,
                 data_type=SpectralDataType.POWER, device=None):
        super().__init__(num, samplate, radix2_exp, low_fre, high_fre,
                         window_type, slide_length, data_type, device)
        if num < 12 or num % 12 != 0:
            num = 12
        self.num = num
        lo = float(_sc.hz_to_log(self.low_fre, 12))
        hi = float(_sc.hz_to_log(self.high_fre, 12))
        self.base_num = int(hi - lo) + 1
        self._fold = chroma_cqt_filter_bank(num, self.base_num, 12,
                                            self.base_fre)
        self._build_exec()

    def _build_exec(self):
        super()._build_exec()
        self._fold_t = as_tensor(self._fold, self.device)

    def spectrogram(self, data_arr):
        amp, _ = self._deep_amps(data_arr, self.base_num)
        if self.data_type == SpectralDataType.POWER:
            amp = amp * amp
            if self.norm_value != 1:
                amp = torch.pow(amp, self.norm_value)
        out = torch.matmul(amp, self._fold_t.T)
        if self.data_type == SpectralDataType.MAG and self.norm_value != 1:
            out = torch.pow(out, self.norm_value)
        out = chroma_normalize(out, self.chroma_data_normal_type)
        return out.transpose(-1, -2).contiguous()
