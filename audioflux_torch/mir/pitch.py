"""Pitch estimation family: NCF, CEP, HPS, LHS, PEF.

Counterpart of ``audioflux_tpu/mir/pitch.py`` (reference
``src/mir/_pitch_{ncf,cep,hps,lhs,pef}.c``).  All five share the frame
layout ``x[i*slide : i*slide+fft]``, ``T=(n-fft)//slide+1`` and an arg-max
pick over a lag/bin range; each one's per-frame FFT loop is one batched
transform over all frames of all clips:

- NCF: ``ifft(|fft(frame, 2N)|^2)`` is the autocorrelation, computed by
  ``ops.cuda_fft.fft_autocorr_frames`` in one pass from the frames (the
  transform is 2N long, so the circular correlation is the linear one),
  which writes only the lags up to ``max_index``;
- CEP: real cepstrum of log power on ``torch.fft`` (``exact``: the log
  amplifies a kernel's error on near-zero bins into argmax flips);
- HPS/LHS: a 32768-point spectrum (the FFT kernel's real-row route, the
  bins the gather reads) and a (max_index + 1) x harmonics gather;
- PEF: a forward at 2N, a log-grid interpolation (a gather), and a
  cross-correlation with the comb filter at ``xcorr_fft_length``, whose
  spectrum is built once per plan on its device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.ops import cuda_fft
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import WindowType

__all__ = ["PitchNCF", "PitchCEP", "PitchHPS", "PitchLHS", "PitchPEF",
           "autocorr_rows", "autocorr_operands"]


def _round_pow2(n: int) -> int:
    lo = 1
    while lo * 2 <= n:
        lo *= 2
    return lo * 2 if (n - lo) > (lo * 2 - n) else lo


# the two (..., n) operands of the general autocorrelation: the frames
# zero-padded to n, and rev[m] = frame[(-m) mod n]
autocorr_operands = cuda_fft.frame_operands


def autocorr_rows(frames: torch.Tensor, n: int,
                  lags: int | None = None) -> torch.Tensor:
    """``real(ifft(|fft(frames, n)|^2))`` of (..., L) fp32 frames, L <= n/2:
    their autocorrelation at lags 0..lags-1 (None: all n), the circular
    convolution of the frame with its reversal, which the zero padding
    makes the linear correlation.  At n = 4096..16384 one call of
    ``ops.cuda_fft.fft_autocorr_frames`` (on the card the kernel reads the
    frames and writes only the lags asked for); elsewhere
    ``fft_autocorr(frame, rev)`` of the two operands, sliced.  A CPU
    tensor takes the kernels' plain versions."""
    lags = n if lags is None else lags
    if n in cuda_fft.FRAMES_N:
        return cuda_fft.fft_autocorr_frames(frames, n, lags)
    return cuda_fft.fft_autocorr(*autocorr_operands(frames, n))[..., :lags]


class _PitchBase:
    def __init__(self, samplate, low_fre, high_fre, radix2_exp, slide_length,
                 default_lo, default_hi, device):
        if not (high_fre > low_fre and high_fre < samplate / 2):
            low_fre, high_fre = default_lo, default_hi
        self.device = resolve_device(device)
        self.samplate = samplate
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.slide_length = (slide_length if slide_length
                             else self.fft_length // 4)

    def cal_time_length(self, data_length: int) -> int:
        if data_length < self.fft_length:
            return 0
        return (data_length - self.fft_length) // self.slide_length + 1

    def _frames(self, data_arr):
        frames = frame_signal(as_tensor(data_arr, self.device),
                              self.fft_length, self.slide_length)
        if self.window_type != WindowType.RECT:
            frames = frames * self._window_t
        return frames

    def _pick(self, band, base):
        """First arg-max over the last axis, offset by ``base``."""
        return torch.argmax(band, dim=-1) + base


class PitchNCF(_PitchBase):
    """Normalized cross-correlation pitch
    (``python/audioflux/mir/pitch_ncf.py``), plus ``device`` (``None``
    means ``cuda``)."""

    def __init__(self, samplate=32000, low_fre=32.0, high_fre=2000.0,
                 radix2_exp=12, slide_length=None,
                 window_type=WindowType.RECT, device=None):
        super().__init__(samplate, low_fre, high_fre, radix2_exp,
                         slide_length, 32.0, 2000.0, device)
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._window_t = as_tensor(self.window, self.device)
        self.min_index = int(np.round(samplate / self.high_fre))
        self.max_index = int(np.round(samplate / self.low_fre))

    def pitch(self, data_arr):
        """(..., n) -> (..., time) fundamental frequency."""
        L2 = self.fft_length * 2
        acf = autocorr_rows(self._frames(data_arr), L2,
                            min(self.max_index + 1, L2))
        acf = acf / np.sqrt(L2)
        rms = torch.sqrt(acf[..., :1])
        lags = acf[..., self.min_index:self.max_index + 1] / rms
        idx = self._pick(lags, self.min_index)
        return self.samplate / idx.to(torch.float32)


class PitchCEP(_PitchBase):
    """Cepstral pitch (``python/audioflux/mir/pitch_cep.py``), plus
    ``device``."""

    def __init__(self, samplate=32000, low_fre=32.0, high_fre=2000.0,
                 radix2_exp=12, slide_length=None,
                 window_type=WindowType.HAMM, device=None):
        super().__init__(samplate, low_fre, high_fre, radix2_exp,
                         slide_length, 32.0, 2000.0, device)
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._window_t = as_tensor(self.window, self.device)
        self.min_index = int(np.round(samplate / self.high_fre))
        self.max_index = int(np.round(samplate / self.low_fre))

    def pitch(self, data_arr):
        """(..., n) -> (..., time) fundamental frequency."""
        L2 = self.fft_length * 2
        # exact tier: log|F|^2 amplifies a kernel's small error on
        # near-zero bins into cepstral argmax flips
        Fs = afft.fft(self._frames(data_arr), n=L2, dim=-1, exact=True)
        ceps = afft.ifft(torch.log(Fs.abs() ** 2), dim=-1, exact=True).real
        band = ceps[..., self.min_index:self.max_index + 1]
        idx = self._pick(band, self.min_index)
        return self.samplate / (idx + 1).to(torch.float32)


class _HarmonicGrid(_PitchBase):
    def __init__(self, samplate, low_fre, high_fre, radix2_exp, slide_length,
                 window_type, harmonic_count, device):
        super().__init__(samplate, low_fre, high_fre, radix2_exp,
                         slide_length, 32.0, 2000.0, device)
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._window_t = as_tensor(self.window, self.device)
        self.interp_fft_length = _round_pow2(samplate)
        self.min_index = int(np.ceil(self.low_fre))
        self.max_index = int(np.floor(self.high_fre))
        hc = int(harmonic_count) if harmonic_count else 5
        k = samplate // (self.max_index + 1)
        if hc > k:
            hc = max(k, 1)
        self.harmonic_count = hc
        # harmonic gather indices (j*(k+1) for j in 0..max)
        j = np.arange(self.max_index + 1)
        self._hidx = j[:, None] * (np.arange(hc)[None, :] + 1)
        self._hidx_t = torch.from_numpy(self._hidx.reshape(-1)).to(
            self.device)

    def _harmonics(self, data_arr, fn):
        """``fn(|F|)`` of the frames' interp_fft_length-point spectrum at
        the harmonic gather, (..., T, max_index + 1, harmonics).  The
        transform reads the frames as they are (the zeros of the padded
        row are never written) and writes only the bins the gather reads."""
        X = self.interp_fft_length
        K = min(int(self._hidx.max()) + 1, X)
        yr, yi = afft.fft_parts(self._frames(data_arr), n=X, bins=K)
        mag = fn(torch.complex(yr, yi).abs())
        del yr, yi
        g = mag[..., self._hidx_t]
        return g.reshape(g.shape[:-1] + self._hidx.shape)

    def _to_fre(self, score):
        band = score[..., self.min_index:self.max_index + 1]
        idx = self._pick(band, self.min_index)
        return ((idx + 1).to(torch.float32)
                * (self.samplate / self.interp_fft_length))


class PitchHPS(_HarmonicGrid):
    """Harmonic product spectrum (``python/audioflux/mir/pitch_hps.py``),
    plus ``device``."""

    def __init__(self, samplate=32000, low_fre=32.0, high_fre=2000.0,
                 radix2_exp=12, slide_length=None,
                 harmonic_count=5, window_type=WindowType.HAMM, device=None):
        super().__init__(samplate, low_fre, high_fre, radix2_exp,
                         slide_length, window_type, harmonic_count, device)

    def pitch(self, data_arr):
        """(..., n) -> (..., time) fundamental frequency."""
        return self._to_fre(torch.prod(
            self._harmonics(data_arr, lambda m: m), dim=-1))


class PitchLHS(_HarmonicGrid):
    """Log-harmonic summation (``python/audioflux/mir/pitch_lhs.py``),
    plus ``device``."""

    def __init__(self, samplate=32000, low_fre=32.0, high_fre=2000.0,
                 radix2_exp=12, slide_length=None,
                 harmonic_count=5, window_type=WindowType.HAMM, device=None):
        super().__init__(samplate, low_fre, high_fre, radix2_exp,
                         slide_length, window_type, harmonic_count, device)

    def pitch(self, data_arr):
        """(..., n) -> (..., time) fundamental frequency."""
        return self._to_fre(torch.sum(
            self._harmonics(data_arr, torch.log), dim=-1))


class PitchPEF(_PitchBase):
    """Pseudo-energy-filter pitch (``python/audioflux/mir/pitch_pef.py``),
    plus ``device``."""

    def __init__(self, samplate=32000, low_fre=32.0, high_fre=2000.0,
                 cut_fre=4000.0, radix2_exp=12, slide_length=None,
                 window_type=WindowType.HAMM,
                 alpha=10.0, beta=0.5, gamma=1.8, device=None):
        super().__init__(samplate, low_fre, high_fre, radix2_exp,
                         slide_length, 32.0, 2000.0, device)
        if not cut_fre > self.high_fre:
            cut_fre = self.high_fre
        self.cut_fre = float(cut_fre)
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._window_t = as_tensor(self.window, self.device)
        self.alpha, self.beta, self.gamma = float(alpha), float(beta), float(gamma)

        N = self.fft_length
        sr = samplate
        self._linear_fre = np.linspace(0, sr / 2, N + 1).astype(np.float64)
        fre1 = self.cut_fre if sr / 2 > self.cut_fre else sr / 2 - 1
        # start is the literal log10 value 1 -> 10 Hz (_pitch_pef.c:initData)
        self._log_fre = np.logspace(1.0, np.float32(np.log10(np.float32(fre1))),
                                    2 * N).astype(np.float64)

        # min/max index on the log grid (_pitch_pef.c:initData nearest pick)
        lf = self._log_fre
        self.min_index = -1
        self.max_index = 0
        for i in range(1, 2 * N):
            if self.high_fre < lf[i]:
                self.max_index = (i if lf[i] - self.high_fre
                                  < self.high_fre - lf[i - 1] else i - 1)
                break
            if self.min_index != -1:
                continue
            if self.low_fre < lf[i]:
                self.min_index = (i if lf[i] - self.low_fre
                                  < self.low_fre - lf[i - 1] else i - 1)

        bw = np.zeros(2 * N)
        bw[1:2 * N - 1] = (lf[2:] - lf[:-2]) / (2 * 2 * N)
        bw[0] = bw[1]
        bw[-1] = bw[-2]
        self._band_width = bw.astype(np.float32)

        # linear -> log frequency resample (vinterp_linear): the gather
        # positions and weights, uploaded once
        linf = self._linear_fre
        pos = np.clip(np.searchsorted(linf, lf, side="left") - 1, 0, N - 1)
        w = ((lf - linf[pos]) / (linf[pos + 1] - linf[pos])).astype(np.float32)
        self._pos_t = torch.from_numpy(pos).to(self.device)
        self._w_t = as_tensor(w, self.device)
        self._band_width_t = as_tensor(self._band_width, self.device)
        self._log_fre_t = as_tensor(self._log_fre.astype(np.float32),
                                    self.device)
        self._cal_filter()

    def _cal_filter(self):
        """Comb estimate filter from alpha/beta/gamma
        (_pitch_pef.c calEstimateFilter), and its spectrum at
        ``xcorr_fft_length`` on the plan's device."""
        N = self.fft_length
        q = np.logspace(np.log10(self.beta), np.log10(self.alpha + self.beta),
                        N)
        h = 1.0 / (self.gamma - np.cos(2 * np.pi * q))
        pad_num = int((q < 1).sum())
        d = np.empty(N + 1)
        d[0] = q[0]
        d[1:N] = (q[:-1] + q[1:]) / 2
        d[N] = q[N - 1]
        d = np.diff(d)
        det = (d * h).sum() / d.sum()
        self._filter = (h - det).astype(np.float32)
        self._pad_num = pad_num
        self.xcorr_fft_length = 1 << (self.radix2_exp
                                      + (3 if pad_num else 2))
        X = self.xcorr_fft_length
        Ff = afft.fft(as_tensor(np.pad(self._filter, (0, X - N)),
                                self.device))
        # conj(Ff) as parts, for the product with each frame's spectrum
        self._ff_re = Ff.real.contiguous()
        self._ff_im_neg = (-Ff.imag).contiguous()

    def set_filter_params(self, alpha: float, beta: float, gamma: float):
        """Re-derive the comb filter (pitchPEFObj_setFilterParams):
        alpha > 0, 0 <= beta <= 1, gamma > 1."""
        if alpha <= 0:
            raise ValueError("`alpha` must be greater than 0.")
        if beta < 0 or beta > 1:
            raise ValueError("`beta` must be between 0 and 1.")
        if gamma <= 1:
            raise ValueError("`gamma` must be greater than 1.")
        self.alpha, self.beta = float(alpha), float(beta)
        self.gamma = float(gamma)
        self._cal_filter()

    def _log_power(self, data_arr):
        """The frames' power spectrum resampled onto the log grid, (...,
        T, 2 fft_length): the cross-correlation's live samples."""
        N = self.fft_length
        frames = self._frames(data_arr)
        Fs = afft.rfft(frames, n=2 * N, dim=-1)
        power = Fs.real ** 2 + Fs.imag ** 2
        del Fs
        p1 = power[..., self._pos_t]
        p2 = power[..., self._pos_t + 1]
        return (p1 + self._w_t * (p2 - p1)) * self._band_width_t

    def _xcorr_rows(self, data_arr):
        """The cross-correlation's input as the reference builds it: the
        log-grid power placed in (..., T, xcorr_fft_length) zero rows at
        ``pad_num``."""
        X = self.xcorr_fft_length
        return F.pad(self._log_power(data_arr),
                     (self._pad_num,
                      X - self._pad_num - 2 * self.fft_length)).contiguous()

    def _xcorr_spectrum(self, rows):
        """``fft(buf) * conj(Ff)`` as (re, im) parts.  ``rows`` is the
        padded buffer of :meth:`_xcorr_rows` (all xcorr_fft_length bins),
        or the log-grid power of :meth:`_log_power`, which the transform
        places at ``pad_num`` itself; the product is then Hermitian and
        only its first xcorr_fft_length // 2 + 1 bins are formed."""
        X = self.xcorr_fft_length
        if rows.shape[-1] == X:
            br, bi = afft.fft_parts(rows)
        else:
            br, bi = afft.fft_parts(rows, n=X, lo=self._pad_num,
                                    bins=X // 2 + 1)
        m = br.shape[-1]
        fr, fi = self._ff_re[:m], self._ff_im_neg[:m]
        return ((br * fr - bi * fi).contiguous(),
                (br * fi + bi * fr).contiguous())

    def pitch(self, data_arr):
        """(..., n) -> (..., time) fundamental frequency."""
        pr, pi = self._xcorr_spectrum(self._log_power(data_arr))
        xc = afft.ifft_parts(pr, pi, n=self.xcorr_fft_length)
        del pr, pi
        # lag pick (dealResult, len=maxIndex+1): the winning index IS the
        # lag, mapped through the log grid
        band = xc[..., self.min_index:self.max_index + 1]
        lag = self._pick(band, self.min_index)
        return self._log_fre_t[lag]
