"""Harmonic counting/salience over an STFT.

Counterpart of ``audioflux_tpu/mir/harmonic.py`` (reference
``src/mir/harmonic_algorithm.c``): per frame, dB-domain spectral peaks
with look-around height estimation (:325-575), then three sequential
filters (height :579-700, near-merge :700-780, dB-chain :780-940) before
counting peaks inside a frequency band.

Device/host split: the FFT (``ops.fft.rfft``) and the power of every frame
run on the plan's device; the branchy per-frame peak-list editing (tens of
peaks per frame) runs on the host in NumPy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import WindowType

__all__ = ["Harmonic"]


_MIN_HEIGHT = 15.0
_CUT_DB = -50.0
_MIN_DB = 15.0
_MIN_FRE = 30.0


def _corr_sort(key, *others, desc=False):
    order = np.argsort(key, kind="stable")
    if desc:
        order = order[::-1]
    return [key[order]] + [o[order] for o in others]


class Harmonic:
    """API mirrors the C ``harmonicObj_*`` surface, plus ``device``
    (``None`` means ``cuda``).  The FFT runs on the plan's device, the
    per-frame peak chain on the host."""

    def __init__(self, samplate=32000, low_fre=27.0, high_fre=4000.0,
                 radix2_exp=12, window_type=WindowType.HAMM,
                 slide_length=None, device=None):
        self.device = resolve_device(device)
        if not (low_fre < high_fre < samplate / 2):
            low_fre, high_fre = 27.0, 4000.0
        fft_length = 1 << radix2_exp
        self.samplate = samplate
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.radix2_exp = radix2_exp
        self.fft_length = fft_length
        # the C only accepts RECT/HANN/HAMM and silently keeps its HAMM
        # default for anything else (harmonic_algorithm.c:140-143)
        self.window_type = WindowType(window_type)
        if self.window_type > WindowType.HAMM:
            self.window_type = WindowType.HAMM
        self.slide_length = slide_length if slide_length else fft_length // 4
        self.window = get_fft_window(self.window_type, fft_length)
        self._window_t = as_tensor(self.window, self.device)

        self.min_index = int(np.floor(low_fre * fft_length / samplate))
        self.max_index = min(int(np.ceil(high_fre * fft_length / samplate)),
                             fft_length // 2 - 1)
        if self.min_index < 3:
            self.min_index = 3
        self._peaks = None

    def cal_time_length(self, data_length: int) -> int:
        if data_length < self.fft_length:
            return 0
        return (data_length - self.fft_length) // self.slide_length + 1

    # ------------------------------------------------------------------
    def exec(self, data_arr):
        """Run the STFT + peak filter chain; caches per-frame peak lists."""
        x = as_tensor(data_arr, self.device)
        frames = frame_signal(x, self.fft_length, self.slide_length)
        spec = afft.rfft(frames * self._window_t, dim=-1)
        power = (spec.real ** 2 + spec.imag ** 2).cpu().numpy()
        s, e = self.min_index, self.max_index
        P = power[..., s:e + 1]
        dB = 10 * np.log10(np.maximum(P, 1e-30)
                           / self.fft_length / self.fft_length)
        self._power = P
        self._peaks = [self._filter_chain(dB[i]) for i in range(dB.shape[0])]
        return self

    # ------------------------------------------------------------------
    def _find_peaks(self, db):
        """Peak picking with look-around height (:325-575, scale=0)."""
        r_len = len(db)
        out_db, out_fre, out_h, out_idx = [], [], [], []
        j = 1
        while j < r_len - 1:
            pre, cur, nex = db[j - 1], db[j], db[j + 1]
            if not (cur > pre and cur > nex):
                j += 1
                continue
            x_flag = e_flag = 0
            _index = j + 1
            fre = (j + self.min_index) / self.fft_length * self.samplate
            _db = cur
            left = pre
            if j - 2 >= 0:
                left = db[j - 2]
                if left < pre or (left > pre and left < cur
                                  and left - pre < 2 and cur > _CUT_DB):
                    if j - 3 >= 0:
                        pre3 = db[j - 3]
                        if pre3 < left:
                            left = pre3
                            if (db[j - 2] > db[j - 1] and db[j - 2] < cur
                                    and db[j - 2] - db[j - 1] < 2):
                                x_flag = 1
                            if (j - 4 >= 0 and _db - left < _MIN_HEIGHT
                                    and cur > _CUT_DB):
                                if db[j - 4] < pre3:
                                    left = db[j - 4]
                                    e_flag = 1
                else:
                    left = pre
            right = nex
            if j + 2 < r_len:
                right = db[j + 2]
                if right < nex or (right > nex and right < cur
                                   and right - nex < 2 and cur > _CUT_DB):
                    if j + 3 < r_len:
                        nex3 = db[j + 3]
                        if nex3 < right:
                            right = nex3
                            _index = j + 3
                            if (j + 4 < r_len and _db - right < _MIN_HEIGHT
                                    and not e_flag and cur > _CUT_DB):
                                if db[j + 4] < nex3:
                                    right = db[j + 4]
                                    _index = j + 4
                        else:
                            _index = j + 2
                else:
                    right = nex
                    _index = j + 1
            h1, h2 = _db - left, _db - right
            height = min(h1, h2)
            if height > _MIN_HEIGHT and x_flag and h1 < h2 and out_db:
                out_db[-1], out_fre[-1] = _db, fre
                out_h[-1], out_idx[-1] = height, j
            else:
                out_db.append(_db)
                out_fre.append(fre)
                out_h.append(height)
                out_idx.append(j)
            j = _index + 1 if _index >= j else j + 1
        return (np.array(out_db, np.float64), np.array(out_fre, np.float64),
                np.array(out_h, np.float64), np.array(out_idx, np.int64))

    def _filter_chain(self, db_row):
        pdb, pfre, ph, pidx = self._find_peaks(db_row)
        n = len(pdb)
        # dB desc
        pdb, pfre, ph, pidx = _corr_sort(pdb, pfre, ph, pidx, desc=True)
        max_db = pdb[0] if n else -np.inf

        # --- filterHeight (:579-700) ---
        start = 2 if n >= 2 else (1 if n >= 1 else 0)
        f1 = [ (pdb[j], pfre[j], ph[j], pidx[j]) for j in range(start) ]
        first_index = pidx[0] if n >= 1 else 0
        second_index = pidx[1] if n >= 2 else 0
        # rest sorted by fre asc
        if n > start:
            rdb, rfre, rh, ridx = pdb[start:], pfre[start:], ph[start:], pidx[start:]
            rfre, rdb, rh, ridx = _corr_sort(rfre, rdb, rh, ridx)
            pdb = np.concatenate([pdb[:start], rdb])
            pfre = np.concatenate([pfre[:start], rfre])
            ph = np.concatenate([ph[:start], rh])
            pidx = np.concatenate([pidx[:start], ridx])
        for j in range(start, n):
            if ph[j] > _MIN_HEIGHT:
                cur_db = pdb[j]
                pre_db = pdb[j - 1]
                nex_db = pdb[j + 1] if j + 1 < n else pdb[j]
                pre_h = ph[j - 1]
                nex_h = ph[j + 1] if j + 1 < n else ph[j]
                cur_i, pre_i = pidx[j], pidx[j - 1]
                nex_i = pidx[j + 1] if j + 1 < n else pidx[j]
                for s_idx in (first_index, second_index):
                    if s_idx and pre_i < s_idx < cur_i:
                        pre_h = _MIN_HEIGHT + 1
                    if s_idx and cur_i < s_idx < nex_i:
                        nex_h = _MIN_HEIGHT + 1
                if (((cur_db - pre_db > 12) or pre_h > _MIN_HEIGHT)
                        and ((cur_db - nex_db > 12) or nex_h > _MIN_HEIGHT)):
                    f1.append((pdb[j], pfre[j], ph[j], pidx[j]))
        f1.sort(key=lambda t: t[1])  # fre asc

        # --- filterNear (:700-780) ---
        f2 = []
        len1 = len(f1)
        last_flag = 1
        j = 0
        while j < len1 - 1:
            cur = f1[j]
            nxt = f1[j + 1]
            _index = j
            if nxt[1] - cur[1] < _MIN_FRE:
                if j == len1 - 2:
                    last_flag = 0
                if cur[0] < nxt[0]:
                    _index = j + 1
                    if j + 2 < len1:
                        nn = f1[j + 2]
                        if nn[1] - nxt[1] < _MIN_FRE and nxt[0] > nn[0]:
                            j += 1
                j += 1
            f2.append(f1[_index])
            j += 1
        if last_flag and len1:
            f2.append(f1[-1])

        # --- filterDB (:780-940) ---
        f3 = [p for p in f2 if p[0] > -100]
        # jump filter
        out = []
        j = 0
        while j < len(f3):
            out.append(f3[j])
            if j + 3 < len(f3):
                d1, d2, d3, d4 = (f3[j][0], f3[j + 1][0], f3[j + 2][0],
                                  f3[j + 3][0])
                if (d1 - d2 > _MIN_DB and d1 - d3 > _MIN_DB
                        and d4 - d2 > _MIN_DB and d4 - d3 > _MIN_DB):
                    j += 2
            j += 1
        f3 = out
        # left cut up to max, then relative-neighbor keep
        if f3:
            dbs = [p[0] for p in f3]
            mi = int(np.argmax(dbs))
            kept = []
            start_j = 0
            for j in range(mi + 1):
                if max_db - f3[j][0] < _MIN_DB or f3[j][0] > -42:
                    start_j = j
                    kept.append(f3[j])
            len2 = len(f3)
            for j in range(start_j + 1, len2 - 1):
                if (f3[j - 1][0] - f3[j][0] < _MIN_DB
                        or f3[j + 1][0] - f3[j][0] < _MIN_DB):
                    kept.append(f3[j])
            if len2 > 1 and start_j < len2 - 1:
                if (f3[len2 - 2][0] - f3[len2 - 1][0] < _MIN_DB
                        or len2 == 3 or len(kept) == 2):
                    kept.append(f3[len2 - 1])
            f3 = kept
        return f3

    # ------------------------------------------------------------------
    def count_range(self, low: float, high: float):
        """Per-frame count of surviving peaks with low < fre < high
        (reads the cache from the last :meth:`exec`)."""
        if self._peaks is None:
            raise RuntimeError("call exec() first")
        counts = np.zeros(len(self._peaks), np.int64)
        for i, plist in enumerate(self._peaks):
            for (db, fre, h, idx) in plist:
                if fre >= high:
                    break
                if low < fre < high:
                    counts[i] += 1
        return counts

    def harmonic_count(self, data_arr, low_fre: float, high_fre: float):
        """Per-frame harmonic peak count of ``data_arr`` in
        [low_fre, high_fre] (mir/harmonic.py:134 signature + range
        validation against the constructor band)."""
        if self.low_fre > low_fre:
            raise ValueError(f"low_fre must be >= {self.low_fre}")
        if self.high_fre < high_fre:
            raise ValueError(f"high_fre must be <= {self.high_fre}")
        if low_fre > high_fre:
            raise ValueError("low_fre must be <= high_fre")
        self.exec(data_arr)
        return self.count_range(low_fre, high_fre)
