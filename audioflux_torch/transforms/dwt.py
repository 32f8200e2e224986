"""Discrete wavelet transforms: DWT (Mallat), WPT (full packet tree),
SWT (stationary, à trous).

Counterpart of ``audioflux_tpu/transforms/dwt.py`` (reference
``src/{dwt,wpt,swt}_algorithm.c``): periodic padding (half filter length
each side, __periodPadding), *valid* convolution with the decomposition
filters, odd-index downsampling (DWT/WPT) or filter upsampling (SWT, full
convolution).  The dyadic reassignment to the (num, fftLength) display
matrix is a precomputed gather.

Each convolution is a strided window view of the padded signal times the
(reversed) taps as a matrix product (``dsp.conv.window_product``), both
filters in one product, and only the samples kept are computed: every
other window for DWT/WPT, the dilated taps of SWT without their zeros.  A matrix product runs in full
fp32 on the card (``torch.backends.cuda.matmul.allow_tf32`` stays False),
the counterpart of the TPU package's ``Precision.HIGHEST``
``conv_general_dilated``; ``conv1d`` would follow cuDNN's TF32 flag, which
is on by default.  WPT transforms each level of the tree in one step.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.dsp.conv import window_product
from audioflux_torch.filterbank.dwt import wavelet_coef
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.types import WaveletDiscreteType

__all__ = ["DWT", "WPT", "SWT"]


def _periodic_pad(x, half: int):
    """Periodic pad of ``half`` samples each side (modulo indexing,
    dwt_algorithm.c:__periodPadding)."""
    n = x.shape[-1]
    if half <= n:
        return torch.cat([x[..., n - half:], x, x[..., :half]], dim=-1)
    idx = torch.from_numpy(np.arange(-half, n + half) % n).to(x.device)
    return x[..., idx]


def _taps(lo, hi, device):
    """(M, 2) matrix of the two filters, reversed: a window times it is
    the true convolution's output at the window's end."""
    return as_tensor(np.stack([lo[::-1], hi[::-1]], axis=-1), device)


def _dec_step(x, taps):
    """One analysis level: periodic pad + valid convolution + odd
    downsample.  x: (..., n) -> (cA, cD), each (..., n//2)."""
    n, dec = x.shape[-1], taps.shape[0]
    xp = _periodic_pad(x, dec // 2)[..., :n + dec]
    y = window_product(xp[..., 1:], taps, n // 2, step=2)
    return y[..., 0], y[..., 1]


def _dyadic_rows(num: int, fft_length: int) -> np.ndarray:
    """Gather index: row i-1 of the display matrix repeats coef[2^i..2^(i+1))
    in a kLen-strided interleave (dwt_algorithm.c:287-303): column j reads
    coefficient 2^i + j // kLen, kLen = fft_length / 2^i."""
    i = np.arange(1, num + 1)[:, None]
    j = np.arange(fft_length)[None, :]
    return (1 << i) + j // (fft_length >> i)


class _Wavelet:
    """Shared plan state: the filters, on the plan's device."""

    def _set_filters(self, wavelet_type, t1, t2):
        self.wavelet_type = WaveletDiscreteType(wavelet_type)
        self.t1, self.t2 = t1, t2
        self.lo_d, self.hi_d = wavelet_coef(self.wavelet_type, t1, t2, 0)
        self._build_exec()

    def _build_exec(self):
        self._taps_t = _taps(self.lo_d, self.hi_d, self.device)
        rows = getattr(self, "_rows", None)
        self._rows_t = (None if rows is None
                        else torch.from_numpy(rows).to(self.device))

    def _input(self, data_arr):
        x = as_tensor(data_arr, self.device)
        if x.shape[-1] != self.fft_length:
            raise ValueError(f"data length must be {self.fft_length}")
        return x


class DWT(_Wavelet):
    """API mirrors ``python/audioflux/dwt.py``: ``dwt(x)`` returns
    (coef_arr, m_data_arr) of shapes (..., fftLength) / (..., num,
    fftLength); plus ``device`` (``None`` means ``cuda``)."""

    def __init__(self, num=None, radix2_exp=12, samplate=32000,
                 wavelet_type=WaveletDiscreteType.SYM, t1=4, t2=0,
                 device=None):
        if num is None:
            num = radix2_exp - 1
        if not 1 <= num <= radix2_exp - 1:
            raise ValueError("num must be in [1, radix2_exp-1]")
        self.device = resolve_device(device)
        self.num = num
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.fft_length = 1 << radix2_exp
        self.bin_band_arr = np.array([1 << (i + 1) for i in range(num)],
                                     np.int64)
        self.fre_band_arr = (self.bin_band_arr * samplate
                             / self.fft_length).astype(np.float32)
        self._rows = _dyadic_rows(num, self.fft_length)
        self._set_filters(wavelet_type, t1, t2)

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def get_bin_band_arr(self):
        return self.bin_band_arr

    def dwt(self, data_arr):
        cA = self._input(data_arr)
        pieces = []
        for _ in range(self.num):
            cA, cD = _dec_step(cA, self._taps_t)
            pieces.append(cD)
        # coef layout: [cA_final | cD_num | ... | cD_1]
        coef = torch.cat([cA] + pieces[::-1], dim=-1)
        return coef, coef[..., self._rows_t]

    def y_coords(self):
        return self.fre_band_arr

    def x_coords(self):
        return np.arange(self.fft_length) / self.samplate


class WPT(_Wavelet):
    """Wavelet packet transform (full binary tree with gray-code child
    ordering, wpt_algorithm.c:236-243), plus ``device``."""

    def __init__(self, num=None, radix2_exp=12, samplate=32000,
                 wavelet_type=WaveletDiscreteType.SYM, t1=4, t2=0,
                 device=None):
        if num is None:
            num = radix2_exp - 1
        if not 1 <= num <= radix2_exp - 1:
            raise ValueError("num must be in [1, radix2_exp-1]")
        self.device = resolve_device(device)
        self.num = num
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.fft_length = 1 << radix2_exp
        # reassign gather: row i repeats leaf i with kLen stride
        # (wpt_algorithm.c:253-270): column j reads leaf sample j // kLen
        L = self.fft_length
        down = L >> self.num
        rows = (np.arange(1 << self.num)[:, None] * down
                + np.arange(L)[None, :] // (L // down))
        self._rows = rows
        self._set_filters(wavelet_type, t1, t2)

    def get_fre_band_arr(self):
        """Leaf-band frequencies, 2**num points over [0, samplate/2]
        (reference wpt.py:135 hardcodes 16000 = 32000/2 regardless of
        samplate; generalized to samplate/2 — identical at the default
        rate)."""
        return np.linspace(0, self.samplate / 2.0, 1 << self.num,
                           dtype=np.float32)

    def wpt(self, data_arr):
        """The tree level by level: level l's 2^l nodes, in node order,
        go through one analysis step; node i's children are 2i+1 and 2i+2,
        swapped where i is even and nonzero (at level l >= 1, the odd
        positions)."""
        x = self._input(data_arr)
        nodes = x[..., None, :]                 # (..., 2^l, L / 2^l)
        for level in range(self.num):
            a, d = _dec_step(nodes, self._taps_t)
            if level:
                swap = torch.arange(a.shape[-2], device=a.device) % 2 == 1
                a, d = (torch.where(swap[:, None], d, a),
                        torch.where(swap[:, None], a, d))
            nodes = torch.stack([a, d], dim=-2).flatten(-3, -2)
        coef = nodes.flatten(-2)
        return coef, coef[..., self._rows_t]

    def y_coords(self):
        return np.linspace(0, self.samplate / 2, 1 << self.num)

    def x_coords(self):
        return np.arange(self.fft_length) / self.samplate


class SWT(_Wavelet):
    """Stationary wavelet transform (à trous: no downsampling, filters
    upsampled per level, swt_algorithm.c:178-248), plus ``device``."""

    def __init__(self, num, fft_length, wavelet_type=WaveletDiscreteType.SYM,
                 t1=4, t2=0, device=None):
        if num < 1:
            raise ValueError("num must be >= 1")
        if fft_length % (1 << num) != 0:
            raise ValueError("fft_length must be divisible by 2**num")
        self.device = resolve_device(device)
        self.num = num
        self.fft_length = fft_length
        self._set_filters(wavelet_type, t1, t2)

    def swt(self, data_arr):
        """(..., fft_length) -> (approx (..., num, L), detail (..., num, L)).

        Level i convolves with the taps upsampled by 2^i (``up`` = dec·2^i
        values, dec of them nonzero) and keeps the full convolution's
        window [up, up + L): output j is sum_r h[dec-1-r] xp[j + 2^i(r+1)]
        over the periodic pad ``xp`` (swt_algorithm.c:213-230), the
        dilated window below."""
        cur = self._input(data_arr)
        L = self.fft_length
        dec = self._taps_t.shape[0]
        approx, detail = [], []
        for i in range(self.num):
            up, s = dec << i, 1 << i
            xp = _periodic_pad(cur, up // 2)[..., :L + up]
            y = window_product(xp[..., s:], self._taps_t, L, dilation=s)
            approx.append(y[..., 0])
            detail.append(y[..., 1])
            cur = y[..., 0]
        return torch.stack(approx, dim=-2), torch.stack(detail, dim=-2)
