"""STFT peak-based pitch with trist candidate resolution.

Counterpart of ``audioflux_tpu/mir/pitch_stft.py`` (reference
``src/mir/_pitch_stft.c``): per frame, power-spectrum peaks in the
(quirky, effectively fixed) bin range are frequency-corrected
(correct_hamm), measured for dB height with a 2-bin look-around, collected
dB-descending, then the top candidates are resolved to a fundamental by
``trist`` (``mir/_trist.py``).

Device/host split: the FFT (``ops.fft.rfft``), the power and the
vectorized peak correction run on the plan's device; the per-frame
candidate walk and the trist rules run on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.mir._trist import trist
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.correct import correct_fn
from audioflux_torch.ops.frame import frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import WindowType

__all__ = ["PitchSTFT"]


class PitchSTFT:
    """API mirrors ``python/audioflux/mir/pitch_stft.py:64-160``, plus
    ``device`` (``None`` means ``cuda``).  The FFT runs on the plan's
    device, the per-frame peak walk on the host."""

    def __init__(self, samplate=32000, low_fre=32.0, high_fre=2000.0,
                 radix2_exp=12, slide_length=1024,
                 window_type=WindowType.HAMM, device=None):
        self.device = resolve_device(device)
        fft_length = 1 << radix2_exp
        if not (high_fre > low_fre):
            low_fre, high_fre = 27.0, 2093.0
        self.samplate = samplate
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.radix2_exp = radix2_exp
        self.fft_length = fft_length
        self.slide_length = slide_length if slide_length else fft_length // 4
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, fft_length)
        self._window_t = as_tensor(self.window, self.device)

        # reference index quirk (_pitch_stft.c:153-162): the swap makes the
        # reset branch fire for any low<high, fixing the range to
        # [3, ceil(2093*N/sr)]
        min_index = int(np.floor(high_fre * fft_length / samplate))
        max_index = min(int(np.ceil(low_fre * fft_length / samplate)),
                        fft_length // 2 - 1)
        if min_index >= max_index:
            min_index = 3
            max_index = int(np.ceil(2093 * fft_length / samplate))
        self.min_index = min_index
        self.max_index = max_index
        self._min_height = 20.0

    def cal_time_length(self, data_length: int) -> int:
        if data_length < self.fft_length:
            return 0
        return (data_length - self.fft_length) // self.slide_length + 1

    # ------------------------------------------------------------------
    def _spectrum(self, data_arr):
        """The device stage: (power, fractional-bin correction) of every
        frame and bin, as host float32 arrays (T, fft_length // 2 + 1)."""
        x = as_tensor(data_arr, self.device)
        frames = frame_signal(x, self.fft_length, self.slide_length)
        spec = afft.rfft(frames * self._window_t, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        # vectorized fractional-bin correction for every bin
        mag = torch.sqrt(power)
        left = F.pad(mag[..., :-1], (1, 0))
        right = F.pad(mag[..., 1:], (0, 1))
        scale, _ = correct_fn(self.window_type)(mag, left, right)
        return power.cpu().numpy(), scale.cpu().numpy()

    def pitch(self, data_arr):
        """(n,) -> (fre_arr, db_arr) per frame."""
        power, scale = self._spectrum(data_arr)
        if power.ndim != 2:
            raise ValueError("PitchSTFT.pitch expects a single (n,) signal")

        T = power.shape[0]
        fre_out = np.zeros(T, np.float32)
        db_out = np.zeros(T, np.float32)
        s_index = int(round(1000.0 * self.fft_length / self.samplate))
        N2 = self.fft_length * self.fft_length

        for i in range(T):
            P = power[i]
            dbs, fres, heights, midis = [], [], [], []
            f_fre, f_db, f_h, f_midi = [], [], [], []
            c1 = c2 = 0
            j = self.min_index + 1
            while j < self.max_index:
                pre, cur, nex = P[j - 1], P[j], P[j + 1]
                if not (cur > pre and cur > nex):
                    j += 1
                    continue
                _index = j + 1
                fre = (j + scale[i, j]) / self.fft_length * self.samplate
                db = 10 * np.log10(max(cur, 1e-30) / N2)
                midi = int(round(12 * np.log2(max(fre, 1e-12) / 440) + 69))
                # look-around height (:115-180)
                lft = pre
                if j - 2 >= 0:
                    lft = P[j - 2]
                    if lft < pre:
                        if j - 3 >= 0 and P[j - 3] < lft:
                            lft = P[j - 3]
                    else:
                        lft = pre
                rgt = nex
                if j + 2 < self.fft_length // 2:
                    rgt = P[j + 2]
                    if rgt < nex:
                        if j + 3 < self.fft_length // 2 and P[j + 3] < rgt:
                            rgt = P[j + 3]
                            _index = j + 3
                        else:
                            _index = j + 2
                    else:
                        rgt = nex
                        _index = j + 1
                h1 = db - 10 * np.log10(max(lft, 1e-30) / N2)
                h2 = db - 10 * np.log10(max(rgt, 1e-30) / N2)
                height = min(h1, h2)
                fres.append(fre)
                dbs.append(db)
                heights.append(height)
                midis.append(midi)
                if height >= self._min_height:
                    if j < s_index:
                        c1 += 1
                    elif j < 2 * s_index:
                        c2 += 1
                    f_fre.append(fre)
                    f_db.append(db)
                    f_h.append(height)
                    f_midi.append(midi)
                j = _index + 1 if _index >= j else j + 1

            n = len(fres)
            if n == 0:
                continue
            # dB desc (stable relate sort)
            order = np.argsort(np.asarray(dbs), kind="stable")[::-1]
            pad = max(8, n)
            corr = np.zeros(pad, np.float64)
            db_a = np.full(pad, -120.0)
            h_a = np.zeros(pad)
            m_a = np.zeros(pad, np.int64)
            corr[:n] = np.asarray(fres)[order]
            db_a[:n] = np.asarray(dbs)[order]
            h_a[:n] = np.asarray(heights)[order]
            m_a[:n] = np.asarray(midis)[order]
            db_out[i] = db_a[0]

            nf = len(f_fre)
            fpad = max(8, nf)
            ffre = np.zeros(fpad)
            fdb = np.full(fpad, -120.0)
            fh = np.zeros(fpad)
            fm = np.zeros(fpad, np.int64)
            ffre[:nf] = f_fre
            fdb[:nf] = f_db
            fh[:nf] = f_h
            fm[:nf] = f_midi

            flag, fre = trist(corr, db_a, h_a, m_a, ffre, fdb, fh, fm, c1, c2)
            if flag:
                fre_out[i] = fre
        return fre_out, db_out
