"""Fast S-transform: octave-band partition of the shifted spectrum.

Counterpart of ``audioflux_tpu/transforms/fst.py`` (reference
``src/fst_algorithm.c``): ifftshift -> FFT -> fftshift -> 1/sqrt(L); the
shifted spectrum is partitioned into dyadic segments (lenArr,
:_fstObj_initPartition), each segment ifftshift -> IFFT -> *sqrt(len) ->
fftshift in place, and a precomputed (fre, time) -> segment-sample index
matrix (:_fstObj_initReassign) expands the concatenated segments to the
output grid.  The forward FFT at L runs the FFT kernel on the card (L in
2048..32768); the segments are at most L/4 long and take ``torch.fft``
below 2048, as in the TPU package.  The expansion is one gather.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["FST"]


def _partition(radix2_exp: int) -> np.ndarray:
    R = radix2_exp
    length = 2 * R
    lens = np.zeros(length, np.int64)
    lens[0] = 1
    lens[R - 1] = 1
    lens[R] = 1
    for i in range(1, R - 1):
        lens[i] = 1 << (R - 1 - i)
    for i in range(R + 1, length):
        lens[i] = 1 << (i - R - 1)
    return lens


def _reassign_index(radix2_exp: int) -> np.ndarray:
    L = 1 << radix2_exp
    lens = _partition(radix2_exp)
    idx = np.zeros((L // 2 + 1, L), np.int64)
    value = 0
    for i in range(2 * radix2_exp):
        len1 = int(lens[i])
        len2 = L // len1
        index1 = L - int(lens[:i + 1].sum())
        for j in range(len1):
            ks = np.arange(index1, min(index1 + len1, L // 2 + 1))
            if len(ks):
                idx[ks, len2 * j:len2 * (j + 1)] = value
            value += 1
    return idx


class FST:
    """API mirrors ``python/audioflux/fst.py``, plus ``device`` (``None``
    means ``cuda``)."""

    def __init__(self, radix2_exp: int = 12, min_index: int = None,
                 max_index: int = None, samplate: int = 32000, device=None):
        if radix2_exp < 3:
            raise ValueError("radix2_exp must be >= 3")
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.fft_length = 1 << radix2_exp
        # ctor-level band range (reference fst.py:81-102); fst() args
        # still override per call
        self.min_index = 1 if min_index is None else int(min_index)
        self.max_index = (self.fft_length // 2 - 1 if max_index is None
                          else int(max_index))
        self.num = self.max_index - self.min_index + 1
        self._lens = _partition(radix2_exp)
        self._index = _reassign_index(radix2_exp)
        self._gather = {}           # (min_index, max_index) -> device index

    def fst(self, data_arr, min_index: int = None, max_index: int = None):
        """(..., 2**radix2_exp) -> complex64 (..., max-min+1, fft_length)."""
        L = self.fft_length
        if min_index is None:
            min_index = self.min_index
        if max_index is None:
            max_index = self.max_index
        if min_index < 0:
            min_index = 0
        if max_index > L // 2:
            max_index = L // 2
        if min_index > max_index:
            min_index, max_index = 0, L // 2

        x = as_tensor(data_arr, self.device)
        if x.shape[-1] != L:
            raise ValueError(f"data length must be {L}")
        key = (min_index, max_index)
        if key not in self._gather:
            self._gather[key] = torch.from_numpy(
                self._gather_rows(min_index, max_index)).to(self.device)
        return self._fst_chain(x)[..., self._gather[key]]

    def _gather_rows(self, min_index: int, max_index: int) -> np.ndarray:
        """(nbins, L) expansion index of the band range into the chain's
        value-indexed output."""
        L = self.fft_length
        rows = np.arange(L // 2 - min_index, L // 2 - max_index - 1, -1)
        return self._index[rows]

    def _fst_chain(self, x):
        """The FST segment chain: ifftshift -> FFT -> fftshift -> dyadic
        per-segment IFFTs, concatenated value-indexed -> (..., L)."""
        L = self.fft_length
        R = self.radix2_exp
        xs = torch.cat([x[..., L // 2:], x[..., :L // 2]], dim=-1)
        F = afft.fft(xs, dim=-1)
        F = torch.cat([F[..., L // 2:], F[..., :L // 2]], dim=-1)
        F = F / np.sqrt(L)

        segments = []  # transformed values in buffer order
        pos = 0
        for i in range(2 * R):
            seg_len = int(self._lens[i])
            seg = F[..., pos:pos + seg_len]
            transform = (1 <= i <= R - 2) or (R + 2 <= i <= 2 * R - 1)
            if transform and seg_len > 1:
                h = seg_len // 2
                s = torch.cat([seg[..., h:], seg[..., :h]], dim=-1)
                s = afft.ifft(s, dim=-1) * np.sqrt(seg_len)
                seg = torch.cat([s[..., h:], s[..., :h]], dim=-1)
            segments.append(seg)
            pos += seg_len
        return torch.cat(segments, dim=-1)

    def get_fre_band_arr(self):
        """Frequencies of the ctor band range (reference fst.py:110)."""
        return (np.arange(self.min_index, self.max_index + 1,
                          dtype=np.float32)
                * self.samplate / self.fft_length)

    def y_coords(self, min_index: int = 0, max_index: int = None):
        if max_index is None:
            max_index = self.fft_length // 2
        return (np.arange(min_index, max_index + 1)
                * self.samplate / self.fft_length)

    def x_coords(self):
        return np.arange(self.fft_length) / self.samplate
