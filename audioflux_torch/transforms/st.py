"""Stockwell transform (S-transform).

Counterpart of ``audioflux_tpu/transforms/st.py`` (reference
``src/st_algorithm.c``): one FFT of the signal, then for each frequency bin
k a gaussian frequency window (exp(-factor*2pi^2*j^2/k^(2norm)) wrapped,
st_algorithm.c:_stObj_initWinData) is applied to the circularly shifted
spectrum F[k:k+L] and inverse-transformed.  Bin 0 is the signal mean.  The
per-bin loop (:262-286) is one gather and one batched inverse over every
bin row (``ops.fft``: the FFT kernels at L in 2048..32768 on the card).

The shifted spectrum is gathered as its real and imaginary parts, each
windowed in place, and handed to the inverse as they are: at 64 clips of
4096 samples each complex (..., 2049, 4096) tensor is 4.3 GB, and no
complex copy of the gather, nor a second one of the product, is made.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["ST"]


def _st_windows(fft_length: int, factor: float, norm: float,
                bins: np.ndarray) -> np.ndarray:
    j = np.arange(fft_length, dtype=np.float64)
    j2 = j * j
    jm2 = (j - fft_length) ** 2
    k = bins.astype(np.float64)[:, None]
    with np.errstate(divide="ignore"):
        v = -factor * 2 * np.pi ** 2 / np.power(k, 2 * norm)
    w = np.exp(v * j2[None, :]) + np.exp(v * jm2[None, :])
    w[bins == 0] = 0.0
    return w.astype(np.float32)


def _st_body(x, w_t, idx_t, zero_rows):
    """The rows ``idx_t`` (their windows ``w_t``) of the ST of ``x``:
    FFT, the windowed shifted spectra as float parts, one inverse; the
    rows ``zero_rows`` (bin 0) hold the signal mean.  A bin-sharded ST
    passes each shard's rows."""
    F = afft.fft(x, dim=-1)
    F2r = torch.cat([F.real, F.real], dim=-1)
    F2i = torch.cat([F.imag, F.imag], dim=-1)
    del F
    re = F2r[..., idx_t].mul_(w_t)
    im = F2i[..., idx_t].mul_(w_t)
    del F2r, F2i
    out = afft.ifft_parts(re, im)
    del re, im
    if zero_rows is not None:
        mean = x.mean(dim=-1)[..., None, None].to(out.dtype)
        out[..., zero_rows, :] = mean
    return out


class ST:
    """API mirrors ``python/audioflux/st.py``, plus ``device`` (``None``
    means ``cuda``)."""

    def __init__(self, radix2_exp: int = 12, min_index: int = 1,
                 max_index: int = None, samplate: int = 32000,
                 factor: float = 1.0, norm: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.fft_length = 1 << radix2_exp
        if max_index is None:
            max_index = self.fft_length // 2
        if (min_index >= max_index or min_index < 0
                or max_index > self.fft_length // 2):
            min_index, max_index = 0, self.fft_length // 2
        self.min_index = min_index
        self.max_index = max_index
        self.factor = float(factor)
        self.norm = float(norm)
        self.bin_arr = np.arange(min_index, max_index + 1, dtype=np.int64)
        self._set_windows()

    def _set_windows(self):
        self._windows = _st_windows(self.fft_length, self.factor, self.norm,
                                    self.bin_arr)
        self._build_exec()

    def _build_exec(self):
        """Upload the windows and the shifted-spectrum gather index."""
        L = self.fft_length
        self._w_t = as_tensor(self._windows, self.device)
        self._idx_t = torch.from_numpy(
            self.bin_arr[:, None] + np.arange(L)[None, :]).to(self.device)
        zero = np.flatnonzero(self.bin_arr == 0)
        self._zero_rows = (torch.from_numpy(zero).to(self.device)
                           if len(zero) else None)

    def use_bin_arr(self, bin_arr):
        bin_arr = np.asarray(bin_arr, np.int64)
        if np.all((bin_arr >= 0) & (bin_arr <= self.fft_length // 2)):
            self.bin_arr = bin_arr
            self._set_windows()

    def set_value(self, factor: float, norm: float):
        if factor != self.factor or norm != self.norm:
            self.factor, self.norm = float(factor), float(norm)
            self._set_windows()

    def st(self, data_arr):
        """(..., 2**radix2_exp) -> complex64 (..., nbins, fft_length)."""
        x = as_tensor(data_arr, self.device)
        if x.shape[-1] != self.fft_length:
            raise ValueError(f"data length must be {self.fft_length}")
        return _st_body(x, self._w_t, self._idx_t, self._zero_rows)

    def cst(self, data_arr):
        """Continuous ST over long signals: run the fft-length ST every
        fft/2 samples and splice the middle halves (first window keeps
        its head, the last its tail), the reference's half-overlap splice
        for long-signal CWT (``python/audioflux/cwt.py`` ccwt).  Length
        must be >= 2*(fft_length//2); the bin-0 mean row is the
        per-window mean.  Output covers (data_len // (fft_length//2)) *
        (fft_length//2) samples: the trailing ``data_len % (fft//2)``
        remainder is dropped."""
        x = as_tensor(data_arr, self.device)
        data_len = x.shape[-1]
        win_len = self.fft_length // 4
        step = win_len * 2
        win_count = (data_len // step) - 1
        if win_count < 1:
            raise ValueError(
                f"data length {data_len} too short for cst "
                f"(needs >= {2 * step})")
        parts = []
        for i in range(win_count):
            seg = x[..., i * step:i * step + self.fft_length]
            if seg.shape[-1] != self.fft_length:
                break
            spec = self.st(seg)
            start = 0 if i == 0 else win_len
            end = (self.fft_length if i == win_count - 1
                   else win_len * 3)
            parts.append(spec[..., start:end])
        return torch.cat(parts, dim=-1)

    def get_fre_band_arr(self):
        """Frequencies of the selected bin range (reference st.py:160)."""
        return (np.arange(self.min_index, self.max_index + 1,
                          dtype=np.float32)
                * self.samplate / self.fft_length)

    def y_coords(self, samplate: int = None):
        if samplate is None:
            samplate = self.samplate
        return self.bin_arr * samplate / self.fft_length

    def x_coords(self, samplate: int = None):
        if samplate is None:
            samplate = self.samplate
        return np.arange(self.fft_length) / samplate
