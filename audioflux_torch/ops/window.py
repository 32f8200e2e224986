"""Window generation (host-side precompute; returns NumPy float32).

Covers the reference's 14 window types (``src/dsp/flux_window.c``) with the
same symmetric/periodic conventions: for FFT analysis windows
(``window_calFFTWindow``, ``flux_window.c:890-940``) hann/hamm/blackman/
kaiser/flattop/gauss/blackman-harris/blackman-nuttall are *periodic*
(symmetric window of length N+1, truncated to N) while bartlett/triang/
bartlett-hann/bohman/tukey are *symmetric*.

Windows are constants uploaded once per plan, so they are computed here
in float64 and cast to float32 once.
"""

from __future__ import annotations

import numpy as np

from audioflux_torch.types import WindowType

__all__ = ["get_window", "get_fft_window"]


def _hann(n: np.ndarray, N: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * n / N)


def _hamm(n: np.ndarray, N: int) -> np.ndarray:
    return 0.54 - 0.46 * np.cos(2 * np.pi * n / N)


def _blackman(n: np.ndarray, N: int) -> np.ndarray:
    return 0.42 - 0.5 * np.cos(2 * np.pi * n / N) + 0.08 * np.cos(4 * np.pi * n / N)


def _blackman_harris(n: np.ndarray, N: int) -> np.ndarray:
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    return (a[0] - a[1] * np.cos(2 * np.pi * n / N)
            + a[2] * np.cos(4 * np.pi * n / N)
            - a[3] * np.cos(6 * np.pi * n / N))


def _blackman_nuttall(n: np.ndarray, N: int) -> np.ndarray:
    a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)
    return (a[0] - a[1] * np.cos(2 * np.pi * n / N)
            + a[2] * np.cos(4 * np.pi * n / N)
            - a[3] * np.cos(6 * np.pi * n / N))


def _flattop(n: np.ndarray, N: int) -> np.ndarray:
    a = (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)
    return (a[0] - a[1] * np.cos(2 * np.pi * n / N)
            + a[2] * np.cos(4 * np.pi * n / N)
            - a[3] * np.cos(6 * np.pi * n / N)
            + a[4] * np.cos(8 * np.pi * n / N))


def _bartlett_hann(n: np.ndarray, N: int) -> np.ndarray:
    fac = n / N - 0.5
    return 0.62 - 0.48 * np.abs(fac) + 0.38 * np.cos(2 * np.pi * fac)


def _cosine_family(length: int, fn) -> np.ndarray:
    """Symmetric window of ``length`` built from half-window fn(n, length-1)."""
    if length == 1:
        return np.ones(1)
    n = np.arange(length, dtype=np.float64)
    return fn(np.minimum(n, length - 1 - n), length - 1)


def _kaiser_symmetric(length: int, beta: float) -> np.ndarray:
    if length == 1:
        return np.ones(1)
    n = np.arange(length, dtype=np.float64)
    x = 2.0 * n / (length - 1) - 1.0
    return _i0(beta * np.sqrt(np.maximum(1 - x * x, 0.0))) / _i0(beta)


def _i0(x):
    """Zeroth-order modified Bessel of the first kind, 15-term series.

    Matches the reference's truncated series (``flux_window.c:668-689``) so
    Kaiser windows agree with the C output to float32 precision.
    """
    x = np.asarray(x, dtype=np.float64)
    total = np.ones_like(x)
    term = np.ones_like(x)
    half = x / 2.0
    for k in range(1, 16):
        term = term * half / k
        total = total + term * term
    return total


def _gauss_symmetric(length: int, alpha: float) -> np.ndarray:
    if length == 1:
        return np.ones(1)
    n = np.arange(length, dtype=np.float64)
    center = (length - 1) / 2.0
    # reference: w = exp(-0.5*(2*alpha*(i-det)/(length-1))^2) mirrored about the
    # center -> std = (length-1)/(2*alpha)
    v = 2.0 * alpha * (n - center) / (length - 1)
    return np.exp(-0.5 * v * v)


def _bartlett(length: int) -> np.ndarray:
    if length == 1:
        return np.ones(1)
    n = np.arange(length, dtype=np.float64)
    return 2.0 * np.minimum(n, length - 1 - n) / (length - 1)


def _triang(length: int) -> np.ndarray:
    if length == 1:
        return np.ones(1)
    n = np.arange(length, dtype=np.float64)
    m = np.minimum(n, length - 1 - n)
    if length % 2 == 0:
        return 2.0 * (m + 0.5) / length
    return 2.0 * (m + 1.0) / (length + 1)


def _bohman(length: int) -> np.ndarray:
    if length == 1:
        return np.ones(1)
    fac = np.abs(np.linspace(-1.0, 1.0, length))
    w = (1 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
    w[0] = 0.0
    w[-1] = 0.0
    return w


def _tukey(length: int, alpha: float) -> np.ndarray:
    if alpha <= 0:
        return np.ones(length)
    if alpha >= 1:
        return _cosine_family(length, _hann)
    x = np.linspace(0.0, 1.0, length)
    w = np.ones(length)
    lo = x < alpha / 2
    hi = x >= 1 - alpha / 2
    w[lo] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (x[lo] - alpha / 2)))
    w[hi] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (x[hi] - 1 + alpha / 2)))
    return w


_PERIODIC_FAMILY = {
    WindowType.HANN: _hann,
    WindowType.HAMM: _hamm,
    WindowType.BLACKMAN: _blackman,
    WindowType.BLACKMAN_HARRIS: _blackman_harris,
    WindowType.BLACKMAN_NUTTALL: _blackman_nuttall,
    WindowType.FLATTOP: _flattop,
    WindowType.BARTLETT_HANN: _bartlett_hann,
}


def get_window(window_type: WindowType, length: int, periodic: bool = False,
               *, alpha: float | None = None, dtype=np.float32) -> np.ndarray:
    """Create a window of ``length`` samples.

    ``periodic=True`` computes the symmetric window of ``length+1`` samples and
    drops the last one (reference convention, ``flux_window.c:64-78``).
    """
    window_type = WindowType(window_type)
    if length < 1:
        raise ValueError("length must be >= 1")
    if length == 1:
        return np.ones(1, dtype=dtype)

    n = length + 1 if periodic else length

    if window_type == WindowType.RECT:
        w = np.ones(n)
    elif window_type in _PERIODIC_FAMILY:
        w = _cosine_family(n, _PERIODIC_FAMILY[window_type])
    elif window_type == WindowType.KAISER:
        w = _kaiser_symmetric(n, 5.0 if alpha is None else alpha)
    elif window_type == WindowType.GAUSS:
        w = _gauss_symmetric(n, 2.5 if alpha is None else alpha)
    elif window_type == WindowType.BARTLETT:
        w = _bartlett(n)
    elif window_type == WindowType.TRIANG:
        w = _triang(n)
    elif window_type == WindowType.BOHMAN:
        w = _bohman(n)
    elif window_type == WindowType.TUKEY:
        w = _tukey(n, 0.5 if alpha is None else alpha)
    else:
        raise ValueError(f"unsupported window type {window_type!r}")

    return w[:length].astype(dtype)


# window types that use the periodic variant in FFT analysis
# (reference window_calFFTWindow, flux_window.c:890-940)
_FFT_PERIODIC = frozenset({
    WindowType.HANN, WindowType.HAMM, WindowType.BLACKMAN, WindowType.KAISER,
    WindowType.FLATTOP, WindowType.GAUSS, WindowType.BLACKMAN_HARRIS,
    WindowType.BLACKMAN_NUTTALL, WindowType.TUKEY,
})


def get_fft_window(window_type: WindowType, length: int, dtype=np.float32) -> np.ndarray:
    """Analysis window for STFT-family transforms, matching the reference's
    per-type periodic/symmetric convention."""
    window_type = WindowType(window_type)
    periodic = window_type in _FFT_PERIODIC
    return get_window(window_type, length, periodic=periodic, dtype=dtype)
