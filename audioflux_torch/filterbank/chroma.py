"""Chroma filterbanks: STFT-chroma (Gaussian octave folding) and the
CQT/log-band chroma fold matrix.

Reference: ``src/filterbank/chroma_filterBank.c`` (chroma_stftFilterBank
:13-169, chroma_cqtFilterBank :176-264).
"""

from __future__ import annotations

import numpy as np

__all__ = ["chroma_stft_filter_bank", "chroma_fold_filter_bank"]


def chroma_stft_filter_bank(num: int, fft_length: int, samplate: int,
                            octave_center: float = 5.0,
                            octave_width: float = 2.0) -> np.ndarray:
    """(num, fft_length//2+1) Gaussian chroma bank for STFT power spectra."""
    if num < 12 or num % 12 != 0:
        raise ValueError("num must be a positive multiple of 12")
    n = num // 12
    base_fre = 440.0

    # fractional chroma-bin position of every fft bin
    freqs = np.arange(1, fft_length) / fft_length * samplate
    oct_arr = np.empty(fft_length, dtype=np.float64)
    oct_arr[1:] = num * np.log2(freqs / (base_fre / 16))
    oct_arr[0] = oct_arr[1] - 1.5 * num

    width_arr = np.empty(fft_length, dtype=np.float64)
    width_arr[:-1] = np.maximum(np.diff(oct_arr), 1.0)
    width_arr[-1] = 1.0

    # circular distance of each bin to each chroma class
    i = np.arange(num)[:, None]
    d = oct_arr[None, :] - i + np.round(num / 2.0) + 10 * num
    d = d - np.floor(d / num) * num - np.round(num / 2.0)

    w = np.exp(-0.5 * (2 * d / width_arr[None, :]) ** 2)
    w = w / np.sqrt((w * w).sum(axis=0, keepdims=True))

    m_len = fft_length // 2 + 1
    w = w[:, :m_len]
    if octave_width > 0:
        scale = np.exp(-0.5 * ((oct_arr[:m_len] / num - octave_center)
                               / octave_width) ** 2)
        w = w * scale[None, :]

    # rotate so chroma 0 = C (reference offsets by 3 semitones from A-based)
    w = np.roll(w, -3 * n, axis=0)
    return w.astype(np.float32)


def chroma_fold_filter_bank(num: int, band_length: int, bin_per_octave: int,
                            min_fre: float = 32.703196) -> np.ndarray:
    """(num, band_length) binary fold matrix mapping log-frequency bands
    (bin_per_octave per octave, lowest at ``min_fre``) onto chroma classes."""
    if num > bin_per_octave or bin_per_octave % num != 0:
        raise ValueError("num and bin_per_octave do not map")
    n = bin_per_octave // num
    offset = int(np.ceil(n / 2.0))
    sub = n - offset

    midi_index = int(np.round(12 * np.log2(min_fre / 440.0) + 69)) % 12
    if midi_index > 6:
        midi_index = 12 - midi_index

    fb = np.zeros((num, band_length), dtype=np.float32)
    mod = np.arange(band_length) % bin_per_octave
    for i in range(num):
        if i == 0:
            sel = mod < offset
            if sub:
                sel |= mod >= bin_per_octave - sub
        else:
            start = offset + (i - 1) * n
            sel = (mod >= start) & (mod < start + n)
        fb[i, sel] = 1.0

    if midi_index:
        # NOTE: reference uses n=num//bin_per_octave here (int 0 for num<bpo);
        # effective roll is midi_index*(num//bin_per_octave) rows.
        roll = midi_index * (num // bin_per_octave)
        if roll:
            fb = np.roll(fb, -roll, axis=0)
    return fb
