"""FIR filter design (window method) and frequency response.

Counterpart of ``audioflux_tpu/dsp/filter_design.py``, numpy only as
there (reference ``src/dsp/filterDesign_fir.c`` + ``filterDesign_freqz.c``:
windowed-sinc low/high/band-pass/stop design with DC or passband-center
gain normalization; direct-form FIR/IIR filter; freqz for (b, a) and SOS
cascades; the reference's filtfilt and IIR design files are empty stubs).
"""

from __future__ import annotations

import numpy as np

from audioflux_torch.ops.window import get_window
from audioflux_torch.types import FilterBandType, WindowType

__all__ = ["FilterBandType", "fir1", "fir2", "smooth1", "mean_filter_coeffs",
           "filter_", "filtfilt", "freqz_ba", "freqz_sos"]


def _sinc_low(n, cut):
    x = n * cut
    return np.sinc(x) * cut


def fir2(order: int, wc, band_type: FilterBandType, win: np.ndarray,
         is_no_scale: bool = False) -> np.ndarray:
    """Windowed-sinc FIR with an explicit window of length order+1."""
    band_type = FilterBandType(band_type)
    wc = np.atleast_1d(np.asarray(wc, np.float64))
    if band_type in (FilterBandType.HIGH_PASS, FilterBandType.BAND_STOP) \
            and order % 2 != 0:
        raise ValueError("high/stop order must be even")
    n = np.linspace(-order / 2, order / 2, order + 1)
    if band_type == FilterBandType.LOW_PASS:
        b = _sinc_low(n, wc[0])
    elif band_type == FilterBandType.HIGH_PASS:
        b = np.sinc(n) - _sinc_low(n, wc[0])
    elif band_type == FilterBandType.BAND_PASS:
        b = _sinc_low(n, wc[1]) - _sinc_low(n, wc[0])
    else:  # BAND_STOP
        b = np.sinc(n) - (_sinc_low(n, wc[1]) - _sinc_low(n, wc[0]))
    b = b * np.asarray(win, np.float64)
    if not is_no_scale:
        if band_type in (FilterBandType.LOW_PASS, FilterBandType.BAND_STOP):
            b = b / b.sum()
        else:
            gain = 1.0 if band_type == FilterBandType.HIGH_PASS \
                else (wc[0] + wc[1]) / 2.0
            i = np.arange(order + 1)
            r = np.sum(np.cos(2 * np.pi * i * gain / 2) * b)
            im = np.sum(-np.sin(2 * np.pi * i * gain / 2) * b)
            b = b / np.hypot(r, im)
    return b.astype(np.float32)


def fir1(order: int, wc, band_type: FilterBandType = FilterBandType.LOW_PASS,
         window_type: WindowType = WindowType.HAMM, value: float = None,
         is_no_scale: bool = False) -> np.ndarray:
    """Windowed-sinc FIR with a named window (default hamm)."""
    win = get_window(WindowType(window_type), order + 1, periodic=False,
                     alpha=value, dtype=np.float64)
    return fir2(order, wc, band_type, win, is_no_scale)


def smooth1(order: int) -> np.ndarray:
    """First-derivative smoother taps (filterDesign_smooth1)."""
    if order % 2 == 0:
        raise ValueError("order must be odd")
    m = order // 2
    v1 = float(sum(i * i for i in range(1, m + 1)))
    return np.array([(m - j) / v1 for j in range(order)], np.float32)


def mean_filter_coeffs(order: int) -> np.ndarray:
    return np.full(order, 1.0 / order, np.float32)


def filter_(b, a, x) -> np.ndarray:
    """Direct-form IIR/FIR with zero initial conditions
    (filterDesign_filter)."""
    b = np.asarray(b, np.float64)
    a = np.atleast_1d(np.asarray(a, np.float64))
    x = np.asarray(x, np.float64)
    y = np.zeros_like(x)
    y[..., 0] = b[0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = np.zeros(x.shape[:-1])
        for j in range(min(len(b), i + 1)):
            acc = acc + b[j] * x[..., i - j]
        for k in range(min(len(a) - 1, i)):
            acc = acc - a[k + 1] * y[..., i - k - 1]
        y[..., i] = acc
    return y.astype(np.float32)


def filtfilt(b, a, x) -> np.ndarray:
    """Zero-phase forward-backward filtering (the reference declares this
    but leaves it empty; standard composition provided here)."""
    y = filter_(b, a, x)
    y = filter_(b, a, y[..., ::-1])[..., ::-1]
    return y


def _response(w, coeffs):
    j = np.arange(len(coeffs))
    e = np.exp(-1j * np.outer(w, j))
    return e @ np.asarray(coeffs, np.float64)


def freqz_ba(b, a, fft_length: int = 512, samplate: int = 32000,
             is_whole: bool = False, k_arr=None):
    """(H complex, w Hz) of b/a (filterDesign_freqzBA)."""
    if k_arr is None:
        k_arr = np.linspace(0, 2 * np.pi - 2 * np.pi / fft_length,
                            fft_length)
    n = fft_length if is_whole else fft_length // 2 + 1
    w = np.asarray(k_arr)[:n]
    H = _response(w, b) / _response(w, a)
    return H.astype(np.complex64), (w * samplate / (2 * np.pi)
                                    ).astype(np.float32)


def freqz_sos(sos, fft_length: int = 512, samplate: int = 32000,
              is_whole: bool = False, k_arr=None):
    """Cascade response of (n, 6) second-order sections
    (filterDesign_freqzSOS)."""
    sos = np.asarray(sos, np.float64).reshape(-1, 6)
    if k_arr is None:
        k_arr = np.linspace(0, 2 * np.pi - 2 * np.pi / fft_length,
                            fft_length)
    n = fft_length if is_whole else fft_length // 2 + 1
    w = np.asarray(k_arr)[:n]
    H = np.ones(len(w), np.complex128)
    for row in sos:
        H = H * (_response(w, row[:3]) / _response(w, row[3:]))
    return H.astype(np.complex64), (w * samplate / (2 * np.pi)
                                    ).astype(np.float32)
