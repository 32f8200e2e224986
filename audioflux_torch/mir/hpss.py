"""Harmonic/percussive source separation (median-filter + Wiener masks).

Counterpart of ``audioflux_tpu/mir/hpss.py`` (reference
``src/mir/hpss_algorithm.c``): STFT (hamm) -> magnitude -> median filter
along time (h_order) and frequency (p_order) -> soft masks h^2/(h^2+p^2)
-> resynthesis (:193-330).  A CUDA float32 signal in the HPSS kernels'
domain (``ops.cuda_hpss.supports``: fft_length 2048 or 4096, 4 to 64
frames over a sample) runs three kernels: the magnitude front, the two
medians, and the back end that masks, inverts and overlap-adds, each
recomputing the spectrum from the signal.  Every other input runs the
kernels' plain versions (``ops.fft``: the FFT kernels for a CUDA tensor at
pow2 2048 <= fft_length <= 32768, else ``torch.fft``; PyTorch code between
them) around the same medians (the median kernel, or its plain version on
the CPU).  ``HPSSNMF`` (the NMF variant) is an FFT, the port's NMF (fp32
matrix products) and the paired ISTFT.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.classic.nmf import _nmf_impl
from audioflux_torch.observe import scope, setup_plan
from audioflux_torch.ops import cuda_hpss
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.cuda_median import median_filter_last_axis
from audioflux_torch.ops.frame import (cal_data_length, cal_time_length,
                                       frame_signal)
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.transforms.stft import _istft_tm_pair
from audioflux_torch.types import WindowType

__all__ = ["HPSS", "HPSSNMF"]


def _hpss_impl(x, window, *, fft_length, slide_length, h_order, p_order):
    plan = dict(fft_length=fft_length, slide_length=slide_length)
    if cuda_hpss.supports(x, fft_length, slide_length):
        magnitude, resynth = cuda_hpss.hpss_magnitude, cuda_hpss.hpss_resynth
    else:
        magnitude = cuda_hpss.hpss_magnitude_ref
        resynth = cuda_hpss.hpss_resynth_ref
    mag = magnitude(x, window, **plan)                  # (..., T, m)
    # the time-axis median runs on the inner axis in place (no transposes)
    h = median_filter_last_axis(mag, h_order, dim=-2)
    p = median_filter_last_axis(mag, p_order, dim=-1)
    return resynth(x, window, h, p, **plan)


class HPSS:
    """API mirrors ``python/audioflux/mir/hpss.py:99-230``, plus
    ``device`` (``None`` means ``cuda``)."""

    @setup_plan
    def __init__(self, radix2_exp: int = 12,
                 window_type: WindowType = WindowType.HAMM,
                 slide_length: int = 1024, h_order: int = 21,
                 p_order: int = 31, device=None):
        if h_order < 1 or h_order % 2 == 0 or p_order < 1 or p_order % 2 == 0:
            raise ValueError("h_order/p_order must be odd positive")
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.window_type = WindowType(window_type)
        self.slide_length = slide_length if slide_length else self.fft_length // 4
        self.h_order = h_order
        self.p_order = p_order
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._build_exec()

    def _build_exec(self):
        """Upload the window to the plan's device."""
        self._window_t = as_tensor(self.window, self.device)

    def cal_time_length(self, data_length: int) -> int:
        return cal_time_length(data_length, self.fft_length, self.slide_length)

    def cal_data_length(self, data_length: int) -> int:
        """Output length for ``data_length`` input samples
        (hpssObj_calDataLength, hpss_algorithm.c:96-111: frames the input
        then (T-1)*slide + fft)."""
        if data_length < self.fft_length:
            return 0
        return cal_data_length(self.cal_time_length(data_length),
                               self.fft_length, self.slide_length)

    def hpss(self, data_arr):
        """(..., n) -> (harmonic, percussive), each (..., out_n)."""
        with scope("af.HPSS.hpss"):
            return _hpss_impl(as_tensor(data_arr, self.device), self._window_t,
                              fft_length=self.fft_length,
                              slide_length=self.slide_length,
                              h_order=self.h_order, p_order=self.p_order)


def _flatness(x, dim):
    """Spectral/temporal flatness: geometric / arithmetic mean."""
    x = torch.clamp(x, min=1e-12)
    g = torch.exp(torch.mean(torch.log(x), dim=dim))
    a = torch.mean(x, dim=dim)
    return g / torch.clamp(a, min=1e-12)


def _hpss_nmf_impl(x, window, W0, H0, *, fft_length, slide_length,
                   max_iter, tp, thresh):
    frames = frame_signal(x, fft_length, slide_length)
    D = afft.rfft(frames * window, dim=-1)  # (T, m)
    mag = D.abs()
    phase = D / torch.clamp(mag, min=1e-16)

    V = mag.transpose(-1, -2)  # (m, T)
    W, H = _nmf_impl(V, W0, H0, max_iter=max_iter, tp=tp, thresh=thresh,
                     norm=0)
    # component lens: a percussive basis is spectrally flat (broadband)
    # with a peaked activation; a harmonic one is the opposite.  Compare
    # the two flatnesses per component and route the whole rank-1 term to
    # one side (a mask multiply, as in the JAX package)
    is_h = (_flatness(W, 0) <= _flatness(H, 1)).to(torch.float32)  # (k,)
    Sh = torch.clamp((W * is_h) @ H, min=0.0)           # (m, T)
    Sp = torch.clamp((W * (1.0 - is_h)) @ H, min=0.0)
    h2, p2 = Sh * Sh, Sp * Sp
    denom = torch.clamp(h2 + p2, min=1e-16)
    Hm = (h2 / denom).transpose(-1, -2) * mag      # (T, m)
    Pm = (p2 / denom).transpose(-1, -2) * mag
    return _istft_tm_pair(Hm * phase, Pm * phase, window,
                          fft_length=fft_length, slide_length=slide_length,
                          method_type=0)


class HPSSNMF:
    """NMF-based harmonic/percussive separation, plus ``device`` (``None``
    means ``cuda``).

    The reference advertises this variant ("HPSS - Median filtering, NMF
    algorithm", ``python/audioflux/mir/hpss.py:16``) but its C core only
    implements the median path, so the composition (the JAX package's
    design) is built from the reference's own NMF
    (``src/classic/nmf.c:112-235``): magnitude STFT -> rank-k NMF ->
    per-component harmonic/percussive routing by spectral-vs-temporal
    flatness -> Wiener masks -> two ISTFTs in one inverse transform.

    Single (n,) signals only (NMF state is per-signal).  ``W0``/``H0`` are
    ``np.random.default_rng(seed)`` draws, the JAX package's.
    """

    def __init__(self, radix2_exp: int = 12,
                 window_type: WindowType = WindowType.HAMM,
                 slide_length: int = 1024, k: int = 16,
                 max_iter: int = 200, tp: int = 0, thresh: float = 1e-3,
                 device=None):
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.window_type = WindowType(window_type)
        self.slide_length = slide_length if slide_length else self.fft_length // 4
        self.k = k
        self.max_iter = max_iter
        self.tp = tp
        self.thresh = thresh
        self.window = get_fft_window(self.window_type, self.fft_length)
        self._window_t = as_tensor(self.window, self.device)

    def cal_time_length(self, data_length: int) -> int:
        return cal_time_length(data_length, self.fft_length, self.slide_length)

    def hpss(self, data_arr, seed: int = 0):
        """(n,) -> (harmonic, percussive), each (out_n,)."""
        x = as_tensor(data_arr, self.device)
        if x.ndim != 1:
            raise ValueError("HPSSNMF.hpss expects a single (n,) signal")
        m = self.fft_length // 2 + 1
        t = self.cal_time_length(x.shape[0])
        rng = np.random.default_rng(seed)
        W0 = as_tensor(rng.random((m, self.k)), self.device)
        H0 = as_tensor(rng.random((self.k, t)), self.device)
        return _hpss_nmf_impl(x, self._window_t, W0, H0,
                              fft_length=self.fft_length,
                              slide_length=self.slide_length,
                              max_iter=self.max_iter, tp=self.tp,
                              thresh=float(self.thresh))
