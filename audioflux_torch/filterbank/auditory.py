"""Auditory filterbank generation: 11 scales x 11 styles x 3 normalizations.

Host-side precompute (NumPy); the resulting ``(num, fft//2+1)`` float32 matrix
is uploaded once as a device constant and applied as a matrix product.

Math follows the reference ``src/filterbank/auditory_filterBank.c`` exactly:
band edges are computed in float32 (including the float32 ``linspace`` step
recurrence and ``roundf`` bin snapping) so that bin indices — the only
discrete decisions — are bit-identical to the C library.
"""

from __future__ import annotations

import numpy as np

from audioflux_torch.types import (
    SpectralFilterBankNormalType,
    SpectralFilterBankScaleType,
    SpectralFilterBankStyleType,
    WindowType,
)
from audioflux_torch.ops.window import get_window
from audioflux_torch.filterbank import scales as _sc
from audioflux_torch.filterbank._libm import cosf, expf, sinf

__all__ = ["auditory_filter_bank", "gammatone_coefficients", "band_edges"]

_STYLE_TO_WINDOW = {
    SpectralFilterBankStyleType.HANN: WindowType.HANN,
    SpectralFilterBankStyleType.HAMM: WindowType.HAMM,
    SpectralFilterBankStyleType.BLACKMAN: WindowType.BLACKMAN,
    SpectralFilterBankStyleType.BOHMAN: WindowType.BOHMAN,
    SpectralFilterBankStyleType.KAISER: WindowType.KAISER,
    SpectralFilterBankStyleType.GAUSS: WindowType.GAUSS,
}


def _linspace_f32(start: float, stop: float, length: int) -> np.ndarray:
    """float32 linspace with the reference's step-recurrence rounding
    (``flux_vector.c:2145-2162``: arr[i] = start + i*step, all float32)."""
    start = np.float32(start)
    step = np.float32((np.float32(stop) - start) / np.float32(max(length - 1, 1)))
    return (start + np.arange(length, dtype=np.float32) * step).astype(np.float32)


def _scale_funcs(scale_type, ref):
    S = SpectralFilterBankScaleType
    if scale_type == S.LINEAR:
        return (lambda f: np.round(np.float32(f) / np.float32(ref)),
                lambda v: np.float32(v) * np.float32(ref))
    if scale_type == S.LINSPACE:
        return (lambda f: np.float32(f), lambda v: np.float32(v))
    if scale_type == S.MEL:
        return _sc.hz_to_mel, _sc.mel_to_hz
    if scale_type == S.BARK:
        return _sc.hz_to_bark, _sc.bark_to_hz
    if scale_type == S.ERB:
        return _sc.hz_to_erb, _sc.erb_to_hz
    if scale_type in (S.OCTAVE, S.LOG_CHROMA):
        return (lambda f: _sc.hz_to_log(f, ref), lambda v: _sc.log_to_hz(v, ref))
    if scale_type == S.LOG:
        return _sc.hz_to_logspace, _sc.logspace_to_hz
    raise ValueError(f"unsupported scale type {scale_type!r}")


def _revise_fre(scale_type, num, low_fre, high_fre, bin_per_octave,
                samplate, fft_length, is_edge):
    """Adjust [low, high] so the num bands tile the scale exactly
    (reference __revise*Fre, auditory_filterBank.c:926-1021)."""
    S = SpectralFilterBankScaleType
    det = 0 if is_edge else 2
    offset = 0 if is_edge else 1
    ref = 0.0

    if scale_type == S.OCTAVE or scale_type == S.LOG_CHROMA:
        if scale_type == S.OCTAVE:
            ref = bin_per_octave if (bin_per_octave and 4 <= bin_per_octave <= 48) else 12
        else:
            ref = bin_per_octave if (bin_per_octave >= 12 and bin_per_octave % 12 == 0) else 12
        low = _sc.hz_to_log(low_fre, ref) - np.float32(offset)
        high = low + np.float32(num - 1 + det)
        low_fre = float(_sc.log_to_hz(low, ref))
        high_fre = float(_sc.log_to_hz(high, ref))
    elif scale_type == S.LINEAR:
        ref = np.float32(samplate) * np.float32(1.0) / np.float32(fft_length)
        low = np.float32(np.round(np.float32(low_fre) / ref)) - np.float32(offset)
        high = low + np.float32(num - 1 + det)
        low_fre = float(low * ref)
        high_fre = float(high * ref)
        ref = float(ref)
    elif scale_type == S.LINSPACE:
        if not is_edge:
            det_fre = (np.float32(high_fre) - np.float32(low_fre)) / np.float32(num - 1)
            low_fre = float(np.float32(low_fre) - det_fre)
            high_fre = float(np.float32(high_fre) + det_fre)
    elif scale_type == S.LOG:
        if not is_edge:
            lo = _sc.hz_to_logspace(low_fre)
            hi = _sc.hz_to_logspace(high_fre)
            det_v = (hi - lo) / np.float32(num - 1)
            low_fre = float(_sc.logspace_to_hz(lo - det_v))
            high_fre = float(_sc.logspace_to_hz(hi + det_v))
    return low_fre, high_fre, ref


def band_edges(num, fft_length, samplate, scale_type,
               low_fre, high_fre, bin_per_octave=12,
               style_type=SpectralFilterBankStyleType.SLANEY):
    """Compute the (num+2,) band frequencies and bin indices.

    Returns (fre_band, bin_band) with the edge points included (non-gammatone
    layout). Reference __auditory_calBandEdge (auditory_filterBank.c:594-677).
    """
    is_edge = style_type == SpectralFilterBankStyleType.GAMMATONE
    det = 0 if is_edge else 2
    low_fre, high_fre, ref = _revise_fre(
        scale_type, num, low_fre, high_fre, bin_per_octave, samplate, fft_length, is_edge)

    if scale_type == SpectralFilterBankScaleType.OCTAVE:
        ref_bpo = bin_per_octave if (bin_per_octave and 4 <= bin_per_octave <= 48) else 12
    elif scale_type == SpectralFilterBankScaleType.LOG_CHROMA:
        ref_bpo = bin_per_octave if (bin_per_octave >= 12 and bin_per_octave % 12 == 0) else 12
    else:
        ref_bpo = ref

    func1, func2 = _scale_funcs(scale_type, ref_bpo)
    low = np.float32(func1(np.float32(low_fre)))
    high = np.float32(func1(np.float32(high_fre)))

    vals = _linspace_f32(low, high, num + det)
    fre_band = np.asarray(func2(vals), dtype=np.float32)

    if style_type == SpectralFilterBankStyleType.SLANEY:
        # bin = first grid index whose frequency exceeds the band frequency
        grid = _linspace_f32(0.0, samplate - samplate / float(fft_length), fft_length)
        bin_band = np.searchsorted(grid, fre_band, side="right").astype(np.int64)
    else:
        bin_band = np.round(
            np.float32(fft_length) * fre_band / np.float32(samplate)).astype(np.int64)
    return fre_band, bin_band


def gammatone_coefficients(fre_band: np.ndarray, samplate: int) -> np.ndarray:
    """4th-order gammatone SOS coefficients, one (4, 6) matrix per band.

    Rows are [b0 b1 b2 | a0 a1 a2] (numerator | denominator). Reference
    auditory_calGammatoneCoefficient (auditory_filterBank.c:691-924).

    The gain denominator is a near-cancellation at low center frequencies, so
    this is computed with *per-operation float32 rounding* mirroring the C;
    expressions the C promotes to double (double literals / ``cos``) use
    float64 before the float32 store.
    """
    f = np.asarray(fre_band, dtype=np.float32)
    n = f.shape[0]
    f32 = np.float32
    t = f32(1.0 / samplate)

    f64 = f.astype(np.float64)
    erb = ((f64 / 9.26449 + 24.7) * 2 * np.pi * 1.019).astype(np.float32)
    arg = ((f * f32(2)).astype(np.float64) * np.pi * np.float64(t)
           ).astype(np.float32)
    v = (-t) * expf((-t) * erb)
    cosA, sinA = cosf(arg), sinf(arg)
    pv = f32(np.sqrt(np.float32(3) + np.float32(2 ** 1.5)))
    nv = f32(np.sqrt(np.float32(3) - np.float32(2 ** 1.5)))

    cR = cosf((4 * np.pi * np.float64(t) * f64).astype(np.float32))
    cI = sinf((4 * np.pi * np.float64(t) * f64).astype(np.float32))
    g0 = f32(2) * t * expf(-erb * t)  # float32 chain
    gR = (g0.astype(np.float64)
          * np.cos(2 * np.pi * np.float64(t) * f64)).astype(np.float32)
    gI = (g0.astype(np.float64)
          * np.sin(2 * np.pi * np.float64(t) * f64)).astype(np.float32)

    b1 = f32(-2) * cosA / expf(erb * t)
    b2 = expf(f32(-2) * t * erb)

    k11 = cosA + pv * sinA
    k12 = cosA - pv * sinA
    k13 = cosA + nv * sinA
    k14 = cosA - nv * sinA
    a11, a12, a13, a14 = v * k11, v * k12, v * k13, v * k14

    def _mag(r, i):
        return np.sqrt(r * r + i * i)

    m2t = f32(-2) * t
    r5 = (f32(-2) / expf(f32(2) * t * erb) - f32(2) * cR
          + f32(2) * (f32(1) + cR) / expf(t * erb))
    i5 = f32(-2) * cI + f32(2) * cI / expf(t * erb)
    den5 = (r5 * r5 + i5 * i5) * (r5 * r5 + i5 * i5)
    gain = (_mag(m2t * cR + gR * k11, m2t * cI + gI * k11)
            * _mag(m2t * cR + gR * k12, m2t * cI + gI * k12)
            * _mag(m2t * cR + gR * k13, m2t * cI + gI * k13)
            * _mag(m2t * cR + gR * k14, m2t * cI + gI * k14)
            / den5)

    coef = np.zeros((n, 4, 6), dtype=np.float32)
    a1s = (a11, a12, a13, a14)
    for s in range(4):
        coef[:, s, 0] = t / gain if s == 0 else t
        coef[:, s, 1] = a1s[s] / gain if s == 0 else a1s[s]
        coef[:, s, 2] = 0.0
        coef[:, s, 3] = 1.0
        coef[:, s, 4] = b1
        coef[:, s, 5] = b2
    return coef


def _freqz_sos(coef: np.ndarray, fft_length: int, n_out: int) -> np.ndarray:
    """|H| of cascaded SOS on the rfft grid. coef: (num, 4, 6) -> (num, n_out).

    Float32-faithful to the reference freqz (filterDesign_freqz.c:110-135:
    3-term cos/sin response sums, complex divide, cascaded complex multiply).
    """
    end = np.float32(2 * np.pi)
    w = _linspace_f32(0.0, end - end / np.float32(fft_length), fft_length)[:n_out]
    coef = np.asarray(coef, dtype=np.float32)

    # response of a 3-coef polynomial at -w*j, float32 accumulation
    cosw = np.stack([cosf((-w) * np.float32(j)) for j in range(3)])  # (3, W)
    sinw = np.stack([sinf((-w) * np.float32(j)) for j in range(3)])

    def _resp(c):  # c: (bands, 3) -> (bands, W) float32 accumulate
        re = c[:, 0:1] * cosw[0]
        im = c[:, 0:1] * sinw[0]
        for j in (1, 2):
            re = re + c[:, j:j + 1] * cosw[j]
            im = im + c[:, j:j + 1] * sinw[j]
        return re, im

    Hr = Hi = None
    for s in range(4):
        br, bi = _resp(coef[:, s, 0:3])
        ar, ai = _resp(coef[:, s, 3:6])
        d = ar * ar + ai * ai
        sr_ = (br * ar + bi * ai) / d
        si_ = (bi * ar - br * ai) / d
        if Hr is None:
            Hr, Hi = sr_, si_
        else:
            Hr, Hi = Hr * sr_ - Hi * si_, Hi * sr_ + Hr * si_
    return np.sqrt(Hr * Hr + Hi * Hi)


def _window_shape(style_type, half: int) -> np.ndarray:
    """Full window of length 2*half+1 used for rising/falling band slopes."""
    wt = _STYLE_TO_WINDOW[style_type]
    return get_window(wt, 2 * half + 1, periodic=False, dtype=np.float64)


def auditory_filter_bank(num, fft_length, samplate,
                         scale_type=SpectralFilterBankScaleType.MEL,
                         style_type=SpectralFilterBankStyleType.SLANEY,
                         normal_type=SpectralFilterBankNormalType.NONE,
                         low_fre=0.0, high_fre=None, bin_per_octave=12,
                         is_pseudo=False):
    """Build the (num, fft_length//2+1) filterbank matrix.

    Returns (filter_bank float32, fre_band float32 (num,), bin_band int (num,)).
    Reference entry point: auditory_filterBank (auditory_filterBank.c:56-207).
    """
    scale_type = SpectralFilterBankScaleType(scale_type)
    style_type = SpectralFilterBankStyleType(style_type)
    normal_type = SpectralFilterBankNormalType(normal_type)
    if high_fre is None:
        high_fre = samplate / 2.0

    m_length = fft_length if is_pseudo else fft_length // 2 + 1
    is_edge = style_type == SpectralFilterBankStyleType.GAMMATONE
    offset = 0 if is_edge else 1

    fre_band, bin_band = band_edges(
        num, fft_length, samplate, scale_type, low_fre, high_fre,
        bin_per_octave, style_type)

    # The reference fills a flat row-major buffer and lets high-edge bands
    # write past their row end into the next row's first columns (e.g. slaney
    # falling slope up to bin[i+2]-1 which can exceed fft//2, c:473-475).
    # Those spurious writes persist in its output, so we reproduce them by
    # filling the same flat buffer with the same index arithmetic.
    flat = np.zeros(num * m_length + fft_length, dtype=np.float64)

    def _put(row, col, val):
        idx = row * m_length + col
        flat[idx] = val

    if scale_type == SpectralFilterBankScaleType.LINEAR:
        # one-hot selection at (bin-1) per band (auditory_filterBank.c:339-365)
        bin_band = bin_band.copy()
        bin_band[1:num + 1] -= 1
        for i in range(num):
            _put(i, bin_band[i + 1], 1.0)
    elif style_type == SpectralFilterBankStyleType.SLANEY:
        grid = _linspace_f32(0.0, samplate - samplate / float(fft_length),
                             fft_length).astype(np.float64)
        f64 = fre_band.astype(np.float64)
        widths = np.diff(f64)
        for i in range(num):
            lo, mid, hi = bin_band[i], bin_band[i + 1], bin_band[i + 2]
            j = np.arange(lo, mid)
            _put(i, j, (grid[j] - f64[i]) / widths[i])
            j = np.arange(mid, hi)
            _put(i, j, (f64[i + 2] - grid[j]) / widths[i + 1])
    elif style_type == SpectralFilterBankStyleType.ETSI:
        for i in range(num):
            lo, mid, hi = bin_band[i], bin_band[i + 1], bin_band[i + 2]
            if mid > lo:
                j = np.arange(lo, mid + 1)
                _put(i, j, (j - lo) / float(mid - lo))
            j = np.arange(mid + 1, hi + 1)
            _put(i, j, (hi - j) / float(hi - mid))
    elif style_type == SpectralFilterBankStyleType.GAMMATONE:
        flat[:num * m_length] = _freqz_sos(
            gammatone_coefficients(fre_band, samplate),
            fft_length, m_length).astype(np.float64).reshape(-1)
    elif style_type == SpectralFilterBankStyleType.POINT:
        for i in range(num):
            _put(i, bin_band[i + 1], 1.0)
    elif style_type == SpectralFilterBankStyleType.RECT:
        for i in range(num):
            j = np.arange(bin_band[i], bin_band[i + 2] + 1)
            _put(i, j, 1.0)
    else:  # window-shaped slopes (auditory_filterBank.c:210-316)
        for i in range(num):
            lo, mid, hi = bin_band[i], bin_band[i + 1], bin_band[i + 2]
            if mid > lo:
                w = _window_shape(style_type, mid - lo)
                _put(i, np.arange(lo, mid + 1), w[:mid - lo + 1])
            if hi > mid:
                w = _window_shape(style_type, hi - mid)
                k0 = (2 * (hi - mid) + 1) // 2 + 1
                _put(i, np.arange(mid + 1, hi + 1), w[k0:k0 + (hi - mid)])

    fb = flat[:num * m_length].reshape(num, m_length)

    # normalization (area / bandwidth)
    if normal_type != SpectralFilterBankNormalType.NONE:
        if style_type == SpectralFilterBankStyleType.GAMMATONE:
            if normal_type == SpectralFilterBankNormalType.AREA:
                weight = (fb[:, 0] + fb[:, -1] + 2 * fb[:, 1:-1].sum(axis=1))
            else:
                weight = 1.019 * 24.7 * (0.00437 * fre_band.astype(np.float64) + 1) / 2
        else:
            if normal_type == SpectralFilterBankNormalType.AREA:
                weight = fb.sum(axis=1)
            else:
                weight = (fre_band[2:].astype(np.float64)
                          - fre_band[:num].astype(np.float64)) / 2
        weight = np.where(weight == 0, 1.0, weight)
        fb = fb / weight[:, None]

    if style_type == SpectralFilterBankStyleType.GAMMATONE:
        fb[:, 1:-1] *= 2.0  # one-sided spectrum energy fold (c:582-587)

    out_fre = fre_band[offset:offset + num].astype(np.float32)
    out_bin = bin_band[offset:offset + num].astype(np.int32)
    return fb.astype(np.float32), out_fre, out_bin
