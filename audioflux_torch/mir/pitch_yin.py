"""YIN pitch estimation.

Counterpart of ``audioflux_tpu/mir/pitch_yin.py`` (reference
``src/mir/_pitch_yin.c``): per frame, the difference function is built
from an FFT autocorrelation plus energy cumsums (:330-430), the
cumulative-mean-normalized difference (CMND) is thresholded at 0.1, the
first local trough below threshold is refined by parabolic interpolation
(:462-560).  All frames run batched; the sequential trough search is a
first-true-index reduction.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.observe import scope
from audioflux_torch.ops import cuda_fft
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import frame_signal

__all__ = ["PitchYIN"]


def _yin_impl(x, *, fft_length, slide_length, auto_length, min_index,
              max_index, samplate, thresh, packed_fft=None):
    diff_length = fft_length - auto_length
    frames = frame_signal(x, fft_length, slide_length)  # (..., T, N)

    # autocorrelation via circular convolution with the reversed prefix
    # (_pitch_yin.c:351-369); no aliasing in the taken range.
    if packed_fft is None:
        packed_fft = x.device.type == "cuda"
    if packed_fft:
        # the card: both real transforms ride ONE complex fft.  For
        # z = x + iy, ifft(fft(z)^2) = z (*) z = (x (*) x - y (*) y)
        # + 2i (x (*) y), so Im(ifft(Z^2))/2 is exactly the x (*) rev
        # circular convolution the two-rfft form computes.  Same products
        # to float rounding (~1e-6 rel); the trough threshold sits at 0.1,
        # so knife-edge flips are the documented cross-libm class.  The
        # CPU keeps the rfft form so the golden fixtures stay exact.
        if fft_length in cuda_fft.REGISTER_N:
            # one kernel from the clips: framing, the reversed prefix,
            # fft -> ^2 -> ifft, and only the lags kept
            acf = cuda_fft.fft_autocorr_yin(x, fft_length, slide_length,
                                            auto_length)
        else:
            rev = F.pad(frames[..., :auto_length + 1].flip(-1),
                        (0, fft_length - auto_length - 1))
            if cuda_fft.supports(fft_length):
                # one fused kernel for the whole round trip
                acf_full = cuda_fft.fft_autocorr(frames.contiguous(), rev)
            else:
                Z = afft.fft(torch.complex(frames, rev), dim=-1)
                acf_full = 0.5 * afft.ifft(Z * Z, dim=-1).imag
            acf = acf_full[..., auto_length:]
    else:
        rev = frames[..., :auto_length + 1].flip(-1)
        A = afft.rfft(frames, dim=-1)
        B = afft.rfft(rev, n=fft_length, dim=-1)
        acf = afft.irfft(A * B, n=fft_length, dim=-1)[..., auto_length:]
    acf = torch.where(acf.abs() >= 1e-6, acf, torch.zeros_like(acf))

    # frame energies over sliding auto_length windows (:372-390)
    csum = torch.cumsum(frames * frames, dim=-1)
    e2 = csum[..., auto_length:] - csum[..., :diff_length]
    e2 = torch.where(e2.abs() >= 1e-6, e2, torch.zeros_like(e2))

    diff = e2[..., :1] + e2 - 2.0 * acf  # (..., T, diff)

    # CMND (:398-430)
    num = diff[..., min_index:max_index + 1]
    csum_d = torch.cumsum(diff[..., 1:max_index + 1], dim=-1)
    mean = csum_d / torch.arange(1, max_index + 1, dtype=torch.float32,
                                 device=x.device)
    den = mean[..., min_index - 1:max_index]
    yin = num / (den + 1e-16)  # (..., T, yin_length)

    # parabolic interp offsets (:462-494)
    v1 = yin[..., :-2]
    v2 = yin[..., 1:-1]
    v3 = yin[..., 2:]
    offs = -(v3 - v1) / 2.0 / (2.0 * ((v1 + v3 - 2 * v2) / 2.0) + 1e-16)
    offs = torch.where(offs.abs() <= 1.0, offs, torch.zeros_like(offs))
    interp = F.pad(offs, (1, 1))

    # first trough below thresh (:520-548): the first column needs a strict
    # rise after it, an interior column a strict fall before it and no fall
    # after it, the last column never counts
    below = yin < thresh
    is_trough = torch.cat(
        [(yin[..., :1] < yin[..., 1:2]) & below[..., :1],
         (yin[..., 1:-1] <= yin[..., 2:]) & (yin[..., 1:-1] < yin[..., :-2])
         & below[..., 1:-1],
         torch.zeros_like(below[..., -1:])], dim=-1)
    any_t = is_trough.any(dim=-1)
    # argmax of an integer tensor returns the first of several equal maxima
    t_idx = torch.argmax(is_trough.to(torch.uint8), dim=-1)
    off = torch.gather(interp, -1, t_idx[..., None])[..., 0]
    fre = samplate / (min_index + t_idx + off)
    fre = torch.where(any_t, fre, torch.zeros_like(fre))
    value = torch.gather(yin, -1, t_idx[..., None])[..., 0]
    value = torch.where(any_t, value, torch.zeros_like(value))
    return fre, value, yin, interp


class PitchYIN:
    """API mirrors ``python/audioflux/mir/pitch_yin.py:64-200``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, samplate: int = 32000, low_fre: float = 27.0,
                 high_fre: float = 2000.0, radix2_exp: int = 12,
                 slide_length: int = 1024, auto_length: int = 2048,
                 device=None):
        self.device = resolve_device(device)
        if low_fre < 27:
            low_fre = 27.0
        fft_length = 1 << radix2_exp
        if not (high_fre > low_fre and high_fre < samplate / 2):
            low_fre, high_fre = 27.0, 2093.0
        self.samplate = samplate
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.radix2_exp = radix2_exp
        self.fft_length = fft_length
        self.slide_length = slide_length if slide_length else fft_length // 4
        self.auto_length = (auto_length if 0 <= auto_length < fft_length
                            else fft_length // 2)
        self.thresh = 0.1

        diff_length = fft_length - self.auto_length
        self.min_index = int(np.floor(samplate / self.high_fre))
        self.max_index = min(int(np.ceil(samplate / self.low_fre)),
                             diff_length - 1)

    def set_thresh(self, thresh: float):
        if thresh > 0:
            self.thresh = float(thresh)

    def cal_time_length(self, data_length: int) -> int:
        if data_length < self.fft_length:
            return 0
        return (data_length - self.fft_length) // self.slide_length + 1

    def _run(self, data_arr, packed_fft=None):
        return _yin_impl(as_tensor(data_arr, self.device),
                         fft_length=self.fft_length,
                         slide_length=self.slide_length,
                         auto_length=self.auto_length,
                         min_index=self.min_index, max_index=self.max_index,
                         samplate=float(self.samplate), thresh=self.thresh,
                         packed_fft=packed_fft)

    def pitch(self, data_arr):
        """(..., n) -> (fre_arr, value_arr) each (..., time)."""
        with scope("af.PitchYIN.pitch"):
            fre, value, yin, interp = self._run(data_arr)
            self._yin_mat = yin
            self._interp_mat = interp
            return fre, value

    def get_min_data(self) -> np.ndarray:
        """Per-frame CMND minimum (the C pitch's third output, minArr)."""
        return self._yin_mat.amin(dim=-1).cpu().numpy()

    def get_trough_data(self, data_arr=None):
        """Per-frame trough candidates (pitchYINObj_getTroughData,
        _pitch_yin.c:246 / dealResult:586-625): every CMND local trough
        below thresh, as (fre_rows, trough_rows, len_arr).

        Uses the matrices cached by the last ``pitch`` call, or computes
        them from ``data_arr``.  1-D input only."""
        if data_arr is not None:
            self.pitch(data_arr)
        yin = self._yin_mat.cpu().numpy()
        interp = self._interp_mat.cpu().numpy()
        if yin.ndim != 2:
            raise ValueError("get_trough_data expects 1-D audio input")
        T, yl = yin.shape
        fre_rows, trough_rows, lens = [], [], []
        for i in range(T):
            a = yin[i]
            fres, vals = [], []
            for j in range(yl - 1):
                if j == 0:
                    ok = a[0] < a[1] and a[0] < self.thresh
                else:
                    ok = (a[j] <= a[j + 1] and a[j] < a[j - 1]
                          and a[j] < self.thresh)
                if ok:
                    vals.append(float(a[j]))
                    fres.append(self.samplate
                                / (self.min_index + j + float(interp[i, j])))
            fre_rows.append(np.asarray(fres, np.float32))
            trough_rows.append(np.asarray(vals, np.float32))
            lens.append(len(vals))
        return fre_rows, trough_rows, np.asarray(lens, np.int32)
