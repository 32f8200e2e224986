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

from audioflux_torch.observe import scope, setup_plan
from audioflux_torch.ops import cuda_fft, cuda_yin
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import frame_signal

__all__ = ["PitchYIN"]


def _yin_impl(x, *, fft_length, slide_length, auto_length, min_index,
              max_index, samplate, thresh, packed_fft=None):
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
    return cuda_yin.yin_tail(frames, acf, auto_length=auto_length,
                             min_index=min_index, max_index=max_index,
                             samplate=samplate, thresh=thresh)


class PitchYIN:
    """API mirrors ``python/audioflux/mir/pitch_yin.py:64-200``, plus
    ``device`` (``None`` means ``cuda``)."""

    @setup_plan
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

    def _plan(self) -> dict:
        return dict(fft_length=self.fft_length,
                    slide_length=self.slide_length,
                    auto_length=self.auto_length, min_index=self.min_index,
                    max_index=self.max_index, samplate=float(self.samplate),
                    thresh=self.thresh)

    def _run(self, data_arr, packed_fft=None):
        """The PyTorch form, ``_yin_impl``: (fre, value, yin, interp)."""
        return _yin_impl(as_tensor(data_arr, self.device), **self._plan(),
                         packed_fft=packed_fft)

    def pitch(self, data_arr):
        """(..., n) -> (fre_arr, value_arr) each (..., time).  On the card
        at radix2_exp 11 or 12 one kernel runs YIN from the clips to the
        pitch (``ops.cuda_yin``); every other call runs ``_yin_impl``."""
        with scope("af.PitchYIN.pitch"):
            x = as_tensor(data_arr, self.device)
            if cuda_yin.supports(x, self.fft_length, self.min_index,
                                 self.max_index):
                fre, value, yin = cuda_yin.yin_pitch(x, **self._plan())
            else:
                fre, value, yin, _ = _yin_impl(x, **self._plan())
            self._yin_mat = yin
            return fre, value

    def get_min_data(self) -> np.ndarray:
        """Per-frame CMND minimum (the C pitch's third output, minArr)."""
        return self._yin_mat.amin(dim=-1).cpu().numpy()

    def get_trough_data(self, data_arr=None):
        """Per-frame trough candidates (pitchYINObj_getTroughData,
        _pitch_yin.c:246 / dealResult:586-625): every CMND local trough
        below thresh, as (fre_rows, trough_rows, len_arr).

        Uses the CMND rows cached by the last ``pitch`` call, or computes
        them from ``data_arr``, and their parabolic offsets.  1-D input
        only."""
        if data_arr is not None:
            self.pitch(data_arr)
        yin = self._yin_mat.cpu().numpy()
        interp = cuda_yin.parabolic_offsets(self._yin_mat).cpu().numpy()
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
