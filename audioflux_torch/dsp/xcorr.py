"""Auto/cross-correlation via FFT.

Counterpart of ``audioflux_tpu/dsp/xcorr.py`` (reference
``src/dsp/xcorr_algorithm.c``): full correlation over lags -(n-1)..(n-1),
optional coefficient normalization by sqrt(sum(x^2)*sum(y^2)).  The
transforms at ceil_pow2(2n) go through ``ops.fft`` (the FFT kernels on the
card at lengths 2048..32768): the forwards read the n live samples and
write the half spectrum, the product of two real rows' spectra is
Hermitian and formed on that half, and the inverse takes it as irfft
does.
"""

from __future__ import annotations

from enum import IntEnum

import torch

from audioflux_torch.features.deconv import _ceil_pow2
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["Xcorr", "XcorrNormalType", "xcorr"]


class XcorrNormalType(IntEnum):
    NONE = 0
    COEFF = 1


def xcorr(v1, v2=None, norm_type: XcorrNormalType = XcorrNormalType.COEFF,
          device=None):
    """Returns (corr (..., 2n-1), max_index, max_value).

    Lag of output index i is i-(n-1).  v2=None computes autocorrelation.
    """
    dev = resolve_device(device)
    x = as_tensor(v1, dev)
    n = x.shape[-1]
    L = _ceil_pow2(2 * n)
    ar, ai = afft.fft_parts(x, n=L, bins=L // 2 + 1)
    if v2 is None:
        pr, pi = ar * ar + ai * ai, torch.zeros_like(ar)
        e2 = None
    else:
        y = as_tensor(v2, dev)
        br, bi = afft.fft_parts(y, n=L, bins=L // 2 + 1)
        pr, pi = ar * br + ai * bi, ai * br - ar * bi
        e2 = torch.sum(y * y, dim=-1, keepdim=True)
    r = afft.ifft_parts(pr, pi, n=L)
    out = torch.cat([r[..., L - (n - 1):], r[..., :n]], dim=-1)
    if XcorrNormalType(norm_type) == XcorrNormalType.COEFF:
        e1 = torch.sum(x * x, dim=-1, keepdim=True)
        out = out / torch.sqrt(e1 * (e1 if e2 is None else e2))
    return out, torch.argmax(out, dim=-1), torch.amax(out, dim=-1)


class Xcorr:
    """API mirrors ``python/audioflux/dsp/xcorr.py`` (default NONE like
    the reference's ``xcorr`` method), plus ``device`` (``None`` means
    ``cuda``)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def xcorr(self, data_arr1, data_arr2=None,
              xcorr_normal_type: XcorrNormalType = XcorrNormalType.NONE):
        return xcorr(data_arr1, data_arr2, xcorr_normal_type,
                     device=self.device)
