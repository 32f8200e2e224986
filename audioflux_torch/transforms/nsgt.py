"""Non-stationary Gabor transform.

Counterpart of ``audioflux_tpu/transforms/nsgt.py`` (reference
``src/nsgt_algorithm.c`` + ``src/filterbank/nsgt_filterBank.c``): one
full-signal FFT, then per band a variable-length windowed spectrum slice is
rotated (center to bin 0) and inverse-transformed at the band's own length
(nsgt_algorithm.c:544-620); band cells are expanded onto the common (num,
maxLen) time grid by previous-sample hold (:578-600).

Bands are bucketed by window length, so each bucket is one gather (slice,
clip and rotation folded into its index) and one batched ``ops.fft.ifft``:
the FFT kernels on the card where a length is a power of 2 in
2048..32768, ``torch.fft`` elsewhere; the forward FFT at L runs the
kernel.  The expansion is one gather from the concatenated cells.
EFFICIENT mode uses symmetric windows, STANDARD periodic ones.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from audioflux_torch.filterbank.auditory import (_linspace_f32, _revise_fre,
                                                 _scale_funcs)
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.window import get_window
from audioflux_torch.types import (SpectralFilterBankNormalType,
                                   SpectralFilterBankScaleType,
                                   SpectralFilterBankStyleType, WindowType)
from audioflux_torch.utils.convert import note_to_hz

__all__ = ["NSGT", "NSGTFilterBankType"]


class NSGTFilterBankType(IntEnum):
    EFFICIENT = 0
    STANDARD = 1


_STYLE_TO_WINDOW = {
    SpectralFilterBankStyleType.SLANEY: WindowType.TRIANG,
    SpectralFilterBankStyleType.ETSI: WindowType.BARTLETT,
    SpectralFilterBankStyleType.HANN: WindowType.HANN,
    SpectralFilterBankStyleType.HAMM: WindowType.HAMM,
    SpectralFilterBankStyleType.BLACKMAN: WindowType.BLACKMAN,
    SpectralFilterBankStyleType.BOHMAN: WindowType.BOHMAN,
    SpectralFilterBankStyleType.KAISER: WindowType.KAISER,
    SpectralFilterBankStyleType.GAUSS: WindowType.GAUSS,
}


def _lin32(start, stop, n):
    """float32 grid built like the C's __vlinspace (start + i*step), so
    strict-< tie-breaks at shared grid points match the C output."""
    step = np.float32((np.float32(stop) - np.float32(start))
                      / max(n - 1, 1))
    return (np.float32(start)
            + np.arange(n, dtype=np.float32) * step).astype(np.float32)


def _nsgt_body(x, buckets, expand_t):
    """FFT, one inverse per window-length bucket, the expansion gather:
    (..., L) -> (..., bands, max_time_length)."""
    F = afft.fft(x, dim=-1)
    cells = [afft.ifft(F[..., gidx] * win, dim=-1).flatten(-2)
             for gidx, win in buckets]
    return torch.cat(cells, dim=-1)[..., expand_t]


class NSGT:
    """API mirrors ``python/audioflux/nsgt.py:123-367``, plus ``device``
    (``None`` means ``cuda``)."""

    def __init__(self, num=84, radix2_exp=12, samplate=32000,
                 low_fre=None, high_fre=None, bin_per_octave=12,
                 min_len=3,
                 nsgt_filter_bank_type=NSGTFilterBankType.EFFICIENT,
                 scale_type=SpectralFilterBankScaleType.OCTAVE,
                 style_type=SpectralFilterBankStyleType.SLANEY,
                 normal_type=SpectralFilterBankNormalType.BAND_WIDTH,
                 device=None):
        S = SpectralFilterBankScaleType
        scale_type = S(scale_type)
        style_type = SpectralFilterBankStyleType(style_type)
        normal_type = SpectralFilterBankNormalType(normal_type)
        if scale_type > S.LOG:
            raise ValueError(f"NSGT does not support scale {scale_type.name}")
        if style_type == SpectralFilterBankStyleType.GAMMATONE:
            style_type = SpectralFilterBankStyleType.HANN
        if normal_type == SpectralFilterBankNormalType.AREA:
            normal_type = SpectralFilterBankNormalType.BAND_WIDTH

        fft_length = 1 << radix2_exp
        if not 2 <= num <= fft_length // 2 + 1:
            raise ValueError("num out of range")

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
                samplate, fft_length, is_edge=True)
            if high_fre > samplate / 2.0:
                raise ValueError("lowFre and num too large, overflow")

        self.device = resolve_device(device)
        self.num = num
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.fft_length = fft_length
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.bin_per_octave = bin_per_octave
        self.min_len = max(int(min_len), 1)
        self.nsgt_filter_bank_type = NSGTFilterBankType(nsgt_filter_bank_type)
        self.scale_type = scale_type
        self.style_type = style_type
        self.normal_type = normal_type
        self._build()

    def set_min_length(self, min_length: int = 3):
        """Minimum per-band window length; rebuilds the frame bank
        (nsgtObj_setMinLength, nsgt_algorithm.c:429)."""
        if min_length < 1:
            raise ValueError(
                f"min_length={min_length} cannot be less than 1")
        if min_length != self.min_len:
            self.min_len = int(min_length)
            self._build()

    # ------------------------------------------------------------------
    def _build(self):
        S = SpectralFilterBankScaleType
        num, L, sr = self.num, self.fft_length, self.samplate

        # band edges (nsgt_filterBank.c:__nsgt_calBandEdge, non-edge layout)
        low_fre, high_fre, ref = _revise_fre(
            self.scale_type, num, self.low_fre, self.high_fre,
            self.bin_per_octave, sr, L, is_edge=False)
        if self.scale_type == S.OCTAVE:
            ref_bpo = (self.bin_per_octave
                       if 4 <= self.bin_per_octave <= 48 else 12)
        else:
            ref_bpo = ref
        f1, f2 = _scale_funcs(self.scale_type, ref_bpo)
        lo = np.float32(f1(np.float32(low_fre)))
        hi = np.float32(f1(np.float32(high_fre)))
        f_arr = np.asarray(f2(_linspace_f32(lo, hi, num + 2)), np.float32)
        b_arr = np.round(L * f_arr.astype(np.float64) / sr).astype(np.int64)

        # window lengths
        lens = np.zeros(num, np.int64)
        if self.nsgt_filter_bank_type == NSGTFilterBankType.STANDARD:
            lens = b_arr[2:] - b_arr[:num] + 1
            lens = np.maximum(lens, self.min_len)
        else:
            for i in range(num):
                left, cur, right = b_arr[i], b_arr[i + 1], b_arr[i + 2]
                if right - left >= 1:
                    lens[i] = 2 * max(cur - left, right - cur) + 1
                else:
                    lens[i] = 0
                lens[i] = max(lens[i], self.min_len)

        periodic = (self.nsgt_filter_bank_type == NSGTFilterBankType.STANDARD)
        windows, offsets = [], []
        for i in range(num):
            ln = int(lens[i])
            wt = _STYLE_TO_WINDOW.get(self.style_type)
            if wt is None:  # POINT/RECT and others: ones
                w = np.ones(ln, np.float32)
            else:
                w = get_window(wt, ln, periodic=periodic)
            if self.normal_type == SpectralFilterBankNormalType.BAND_WIDTH:
                w = w / np.sqrt(np.float32(ln))
            windows.append(w.astype(np.float32))
            offsets.append(max(int(b_arr[i + 1]) - ln // 2, 0))

        self.fre_band_arr = f_arr[1:num + 1]
        self.bin_band_arr = b_arr[1:num + 1].astype(np.int32)
        self._lens = lens
        self._windows = windows
        self._offsets = offsets
        self.max_time_length = int(lens.max())
        self.total_time_length = int(lens.sum())

        # expansion gather (nsgt_algorithm.c:__nsgtObj_dealTime + :578-600)
        time = np.float32(L / float(sr))
        max_t = _lin32(0.0, time, self.max_time_length + 1
                       )[:self.max_time_length]
        expand = np.zeros((num, self.max_time_length), np.int64)
        for i in range(num):
            ln = int(lens[i])
            det = max(ln - 2, 0)
            off = np.float32(time) / np.float32(ln + det)
            t_arr = _lin32(-off, np.float32(time) + off, ln + 1)
            # first k with t_arr[k] > max_t[j] (strict), then cell k-1
            k = np.searchsorted(t_arr, max_t, side="right")
            expand[i] = np.clip(k - 1, 0, ln - 1)
        self._expand = expand
        self._build_exec()

    def _build_exec(self):
        self._buckets, self._expand_t = self._band_plan(range(self.num),
                                                        self.device)

    def _band_plan(self, bands, device):
        """For the bands ``bands`` (in order), per length bucket the
        spectrum gather (band slice, clip and rotation by -(ln//2) in one
        index) and the rotated windows; the expansion index into the cells
        concatenated in bucket order.  A band-sharded NSGT plans each
        shard's bands."""
        L = self.fft_length
        bands = list(bands)
        by_len = {}
        for i in bands:
            by_len.setdefault(int(self._lens[i]), []).append(i)
        buckets = []
        start = {}                              # band's first cell
        pos = 0
        for ln, idxs in by_len.items():
            rot = (np.arange(ln) + ln // 2) % ln
            gidx = np.stack([np.clip(self._offsets[i] + rot, 0, L - 1)
                             for i in idxs])
            win = np.stack([self._windows[i][rot] for i in idxs])
            buckets.append((torch.from_numpy(gidx).to(device),
                            as_tensor(win, device)))
            for j, i in enumerate(idxs):
                start[i] = pos + j * ln
            pos += len(idxs) * ln
        first = np.array([start[i] for i in bands], np.int64)
        expand = torch.from_numpy(first[:, None] + self._expand[bands]).to(
            device)
        return buckets, expand

    # ------------------------------------------------------------------
    def get_max_time_length(self):
        return self.max_time_length

    def get_total_time_length(self):
        return self.total_time_length

    def get_time_length_arr(self):
        return self._lens.copy()

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def get_bin_band_arr(self):
        return self.bin_band_arr

    # ------------------------------------------------------------------
    def nsgt(self, data_arr):
        """(..., 2**radix2_exp) -> complex64 (..., num, max_time_length)."""
        x = as_tensor(data_arr, self.device)
        if x.shape[-1] != self.fft_length:
            raise ValueError(f"data length must be {self.fft_length}")
        return _nsgt_body(x, self._buckets, self._expand_t)

    def y_coords(self):
        return self.fre_band_arr

    def x_coords(self, data_length: int = None):
        """Time-axis coordinates (nsgt.py:345: ``data_length`` spread over
        max_time_length+1 points; without it, the legacy per-bin grid)."""
        if data_length is not None:
            return np.linspace(0, data_length / self.samplate,
                               self.max_time_length + 1)
        return (np.arange(self.max_time_length) * self.fft_length
                / self.max_time_length / self.samplate)
