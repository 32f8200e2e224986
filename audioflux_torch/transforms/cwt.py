"""Continuous wavelet transform — frequency-domain mother wavelets.

Counterpart of ``audioflux_tpu/transforms/cwt.py`` (reference
``src/cwt_algorithm.c`` + ``src/filterbank/cwt_filterBank.c``):
symmetric-pad the (2^radix2_exp)-sample signal, FFT once, multiply by the
(num, fft_length) real frequency-domain wavelet bank (morse / morlet / bump
/ paul / dog / mexican / hermit / ricker), then one inverse FFT per scale.

For a CUDA tensor whose padded length is a power of two in the kernel's
domain the bank multiply, the inverse transforms and the un-padding slice
are one kernel call (``ops.cuda_cwt.cwt_ifft_bank``); other lengths take
``ops.fft.ifft``.  The bank is built on the host in float64 and stored
with its rows ascending in frequency, so no output is flipped.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audioflux_torch.filterbank.auditory import (_linspace_f32, _revise_fre,
                                                 _scale_funcs)
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.cuda_cwt import (band_row_counts, cwt_ifft_bank,
                                          supports)
from audioflux_torch.types import (SpectralFilterBankScaleType,
                                   WaveletContinueType)
from audioflux_torch.utils.convert import note_to_hz

__all__ = ["CWT", "cwt_filter_bank"]

_DEFAULT_GB = {
    WaveletContinueType.MORSE: (3.0, 20.0),
    WaveletContinueType.MORLET: (6.0, 2.0),
    WaveletContinueType.BUMP: (5.0, 0.6),
    WaveletContinueType.PAUL: (4.0, 20.0),
    WaveletContinueType.DOG: (2.0, 2.0),
    WaveletContinueType.MEXICAN: (3.0, 2.0),
    WaveletContinueType.HERMIT: (5.0, 2.0),
    WaveletContinueType.RICKER: (4.0, 20.0),
}


def _center_fre(wavelet_type, gamma):
    """Center frequency of every wavelet but MORSE (whose caller derives
    it from gamma and beta)."""
    W = WaveletContinueType
    if wavelet_type in (W.MORLET, W.BUMP, W.RICKER):
        return gamma
    if wavelet_type == W.PAUL:
        return gamma + 0.5
    if wavelet_type == W.DOG:
        return math.sqrt(gamma + 0.5)
    if wavelet_type == W.MEXICAN:
        return math.sqrt(2 + 0.5)
    if wavelet_type == W.HERMIT:
        return gamma + 1.0
    raise ValueError(f"no center frequency rule for {wavelet_type!r}")


def _wavelet_psi(x: np.ndarray, wavelet_type, gamma: float, beta: float,
                 cf: float) -> np.ndarray:
    """Frequency response psi(x) for x = scale*omega (> 0 kept; <=0 zeroed).

    Formulas mirror __cwt_*FilterBank (cwt_filterBank.c generators).
    """
    W = WaveletContinueType
    pos = x > 0
    xp = np.where(pos, x, 1.0)
    if wavelet_type == W.MORSE:
        factor = np.exp(-beta * np.log(cf) + cf ** gamma)
        v = 2.0 * factor * np.exp(beta * np.log(xp) - xp ** gamma)
    elif wavelet_type == W.MORLET:
        v = 2.0 * np.exp(-((xp - cf) ** 2) / beta)
    elif wavelet_type == W.BUMP:
        sigma = beta
        u = (x - cf) / sigma
        inside = np.abs(u) < 1 - 1e-6
        uu = np.where(inside, u, 0.0)
        v = np.where(inside, 2.0 * np.e * np.exp(-1.0 / (1.0 - uu * uu)), 0.0)
        return np.nan_to_num(v, nan=0.0).astype(np.float32)
    elif wavelet_type == W.PAUL:
        p = int(round(gamma))
        fact = 1.0
        for i in range(2, 2 * p):
            fact *= i
        factor = (2.0 ** p) / math.sqrt(p * fact)
        v = factor * xp ** gamma * np.exp(-xp)
    elif wavelet_type in (W.DOG, W.MEXICAN):
        g = 2.0 if wavelet_type == W.MEXICAN else gamma
        p = int(round(g))
        factor = -1.0 / math.sqrt(math.gamma(p + 0.5))
        if (p // 2) % 2 == 1:
            factor = -factor
        v = factor * xp ** g * np.exp(-xp * xp / beta)
    elif wavelet_type == W.HERMIT:
        factor = 2.0 / math.sqrt(gamma) * math.pi ** -0.25
        d = xp - gamma
        v = factor * d * (1 + d) * np.exp(-d * d / beta)
    elif wavelet_type == W.RICKER:
        factor = 2.0 / math.sqrt(math.pi)
        v = factor * xp * xp / gamma ** 3 * np.exp(-xp * xp / gamma ** 2)
    else:
        raise ValueError(f"unsupported wavelet {wavelet_type!r}")
    return np.where(pos, v, 0.0).astype(np.float32)


def _omega_grid(length: int) -> np.ndarray:
    """Angular frequency of each FFT bin, the upper half wrapped negative."""
    w = np.zeros(length, np.float64)
    half = length // 2
    w[:half + 1] = np.arange(half + 1) * 2 * np.pi / length
    w[half + 1:] = -w[1:length - half][::-1]
    return w


def cwt_filter_bank(num, data_length, samplate, pad_length, wavelet_type,
                    gamma, beta, scale_type, low_fre, high_fre,
                    bin_per_octave=12):
    """(bank (num, wLength) float32 scale-ordered high-fre-first,
    fre_band (num,) ascending, bin_band (num,)).

    Mirrors cwt_filterBank (cwt_filterBank.c:cwt_filterBank): non-edge band
    revision, omega grid, scale array cf/(f/sr*2pi), wavelet response.
    """
    W = WaveletContinueType(wavelet_type)
    scale_type = SpectralFilterBankScaleType(scale_type)
    w_length = data_length + 2 * pad_length

    low_fre, high_fre, ref = _revise_fre(
        scale_type, num, low_fre, high_fre, bin_per_octave, samplate,
        data_length, is_edge=False)
    if scale_type == SpectralFilterBankScaleType.OCTAVE:
        ref_bpo = (bin_per_octave
                   if (bin_per_octave and 4 <= bin_per_octave <= 48) else 12)
    else:
        ref_bpo = ref
    func1, func2 = _scale_funcs(scale_type, ref_bpo)
    lo = np.float32(func1(np.float32(low_fre)))
    hi = np.float32(func1(np.float32(high_fre)))
    f_arr = np.asarray(func2(_linspace_f32(lo, hi, num + 2)),
                       dtype=np.float32)

    if W == WaveletContinueType.MORSE:
        cf = float(np.exp(1.0 / gamma * (np.log(beta) - np.log(gamma))))
    else:
        cf = _center_fre(W, gamma)

    w = _omega_grid(w_length)

    # scales: descending band frequency (cwt_filterBank.c sArr loop)
    f_used = np.maximum(f_arr[1:num + 1], 1e-6)[::-1]
    s_arr = cf / (f_used.astype(np.float64) / samplate * 2 * np.pi)

    x = s_arr[:, None] * w[None, :]
    bank = _wavelet_psi(x, W, float(gamma), float(beta), cf)

    fre_band = f_arr[1:num + 1]
    bin_band = np.round(data_length * fre_band.astype(np.float64)
                        / samplate).astype(np.int64)
    return bank, fre_band, bin_band


def _symmetric_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """``p`` mirrored samples per side with the edge sample repeated
    (numpy's "symmetric"; ``torch``'s "reflect" leaves the edge out)."""
    return torch.cat([x[..., :p].flip(-1), x, x[..., -p:].flip(-1)], dim=-1)


def _cwt_conv_body(x: torch.Tensor, bank: torch.Tensor, *, det: bool,
                   pad_length: int, data_length: int, row_h=None):
    """The CWT/PWT filterbank convolution: symmetric pad -> FFT -> bank
    multiply -> per-band inverse FFT -> un-pad (times ``i`` when ``det``).

    x: (..., data_length) float32; bank: (num, w_len) float32 on x's
    device; row_h: the bank's support rows (``ops.cuda_cwt``) or ``None``.
    Where ``ops.cuda_cwt.supports`` holds, everything after the forward
    FFT is ``cwt_ifft_bank`` (the kernel for a CUDA tensor, its plain
    version for a CPU tensor); other lengths multiply and take
    ``ops.fft.ifft``."""
    p = pad_length
    if p:
        x = _symmetric_pad(x, p)
    F = afft.fft(x, dim=-1)                       # (..., w_len) complex64
    w_len = x.shape[-1]
    if supports(w_len, p, data_length):
        lead = F.shape[:-1]
        out = cwt_ifft_bank(F.reshape(-1, w_len).contiguous(), bank, pad=p,
                            length=data_length, det=det, row_h=row_h)
        return out.reshape(lead + out.shape[1:])
    prod = bank * F[..., None, :]
    if det:
        prod = prod * 1j
    out = afft.ifft(prod, dim=-1)
    if p:
        out = out[..., p:p + data_length]
    return out


def _pad_length(data_length: int, is_padding: bool) -> int:
    """Half the signal per side up to 1e5 samples, ceil(log2) above
    (cwt_algorithm.c); 0 without padding."""
    if not is_padding:
        return 0
    return (data_length // 2 if data_length <= 1e5
            else int(np.ceil(np.log2(data_length))))


class CWT:
    """API mirrors ``python/audioflux/cwt.py:128-350``, plus ``device``
    (``None`` means ``cuda``).

    ``cwt(x)``: x must be exactly ``2**radix2_exp`` samples; returns
    complex64 (..., num, data_length), rows ascending in frequency.
    """

    def __init__(self, num=84, radix2_exp=12, samplate=32000,
                 low_fre=None, high_fre=None, bin_per_octave=12,
                 wavelet_type=WaveletContinueType.MORSE,
                 scale_type=SpectralFilterBankScaleType.OCTAVE,
                 gamma=None, beta=None, is_padding=True, device=None):
        S = SpectralFilterBankScaleType
        scale_type = S(scale_type)
        wavelet_type = WaveletContinueType(wavelet_type)
        if scale_type > S.LOG:
            raise ValueError(f"CWT does not support scale {scale_type.name}")
        data_length = 1 << radix2_exp
        if not 2 <= num <= data_length // 2 + 1:
            raise ValueError(f"num={num} out of range")
        self.device = resolve_device(device)

        log_like = scale_type in (S.OCTAVE, S.LOG)
        if low_fre is None:
            low_fre = note_to_hz("C1") if log_like else 0.0  # 32.703
        if high_fre is None:
            high_fre = samplate / 2.0
        if log_like and low_fre < round(note_to_hz("C1"), 3):
            raise ValueError(f"{scale_type.name} low_fre must be >= 32.703")

        dg, db = _DEFAULT_GB[wavelet_type]
        gamma = dg if gamma is None or gamma <= 0 else float(gamma)
        beta = db if beta is None or beta <= 0 else float(beta)
        if wavelet_type == WaveletContinueType.DOG and int(round(gamma)) % 2:
            raise ValueError("DOG gamma must round to an even integer")

        # ctor-level edge revision (cwt_algorithm.c:183-207, isEdge=1)
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
        self.fft_length = data_length  # python wrapper naming
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.bin_per_octave = bin_per_octave
        self.wavelet_type = wavelet_type
        self.scale_type = scale_type
        self.gamma = gamma
        self.beta = beta
        self.is_padding = bool(is_padding)
        self.pad_length = _pad_length(data_length, self.is_padding)

        bank, fre, bins = cwt_filter_bank(
            num, data_length, samplate, self.pad_length, wavelet_type,
            gamma, beta, scale_type, self.low_fre, self.high_fre,
            bin_per_octave)
        # rows ascending in frequency: the wrapper's output flip
        # (cwt.py:277) folded into the constant
        self._bank = np.ascontiguousarray(bank[::-1])
        self.fre_band_arr = fre
        self.bin_band_arr = bins
        self._det_bank = None
        self._build_exec()

    def _build_exec(self):
        """Upload the banks to the plan's device and count their support
        rows (power-of-two padded lengths only: the kernel's)."""
        def upload(bank):
            if bank is None:
                return None, None, None
            n = bank.shape[1]
            rows = band_row_counts(bank, n) if n & (n - 1) == 0 else None
            rows_t = (None if rows is None else
                      torch.tensor(rows, dtype=torch.int32, device=self.device))
            return as_tensor(bank, self.device), rows, rows_t
        self._bank_t, self._row_h, self._row_h_t = upload(self._bank)
        self._det_bank_t, self._det_row_h, self._det_row_h_t = upload(
            self._det_bank)

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def get_bin_band_arr(self):
        return self.bin_band_arr

    def enable_det(self, flag: bool = True):
        """Build the derivative bank (bank * omega; the factor ``i`` is
        applied after the inverse transform) for synchrosqueezing
        (cwt_algorithm.c:cwtObj_enableDet)."""
        if flag and self._det_bank is None:
            w = _omega_grid(self._bank.shape[1])
            self._det_bank = (self._bank * w[None, :]).astype(np.float32)
            self._build_exec()

    def _run(self, data_arr, det: bool):
        x = as_tensor(data_arr, self.device)
        if x.shape[-1] != self.data_length:
            raise ValueError(
                f"data length must be exactly {self.data_length}")
        return _cwt_conv_body(
            x, self._det_bank_t if det else self._bank_t, det=det,
            pad_length=self.pad_length, data_length=self.data_length,
            row_h=self._det_row_h_t if det else self._row_h_t)

    def cwt(self, data_arr):
        return self._run(data_arr, det=False)

    def cwt_det(self, data_arr):
        """CWT with the derivative bank (i*omega*psi) — instantaneous
        frequency numerator for WSST."""
        self.enable_det(True)
        return self._run(data_arr, det=True)

    def ccwt(self, data_arr):
        """Continuous CWT over long signals (reference cwt.py:280-320):
        run the fft-length CWT every fft/2 samples and splice the middle
        halves (the first window keeps its head, the last its tail).
        The length must be a multiple of fft_length//2."""
        data_arr = as_tensor(data_arr, self.device)
        data_len = data_arr.shape[-1]
        win_len = self.fft_length // 4
        step = win_len * 2
        win_count = (data_len // step) - 1
        if win_count < 1:
            raise ValueError(
                f"data length {data_len} too short for ccwt "
                f"(needs >= {2 * step})")
        parts = []
        for i in range(win_count):
            seg = data_arr[..., i * step:i * step + self.fft_length]
            if seg.shape[-1] != self.fft_length:
                break
            spec = self.cwt(seg)
            start = 0 if i == 0 else win_len
            end = (self.fft_length if i == win_count - 1
                   else win_len * 3)
            parts.append(spec[..., start:end])
        return torch.cat(parts, dim=-1)

    def y_coords(self):
        return self.fre_band_arr

    def x_coords(self):
        return np.arange(self.data_length) / self.samplate
