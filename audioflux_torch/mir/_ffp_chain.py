"""FFP candidate-generation chain (exact port of _pitch_ffp.c internals).

Counterpart of ``audioflux_tpu/mir/_ffp_chain.py``: the same host code,
with stage 1's FFT on the plan's device (``ops.fft.rfft``, the FFT kernel
for a CUDA tensor) and its power taken to host float64 as there.  The
window correction of each peak, which the JAX module evaluates one peak
at a time, is evaluated here for every bin at once on the host in float32
(the same float32 operations on the same inputs; the pick between the
neighbours is made on the float64 magnitudes, as there).

Reference ``src/mir/_pitch_ffp.c``: STFT peak extraction with look-around
heights and sub-bin window correction (:2286), per-frame lightness
(:2588, __isLight/__temproal), the filter chain
height→near→dB→relation (:1360-2065) that produces the level-1 candidate
set (``pitchFFPObj_getCorrData``), and the fast chain
preprocess→fast→fastDB→fastCut (:1228, :2065) that produces the level-2/3
sets (``pitchFFPObj_getCutData``).  Array rows are verified against the C
object's getters (tests/test_ffp_chain.py).

The per-frame sets feed ``trist3_resolve`` (the fully-ported _queue
engine) to reproduce ``pitchFFPObj_pitch`` end to end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, host_f32, resolve_device
from audioflux_torch.ops.correct import correct_fn
from audioflux_torch.ops.frame import frame_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import WindowType

_MIN_HEIGHT = 15.0
_CUT_DB = -54.0
_CUT_DB2 = -58.0


class _Row:
    """One frame's candidate arrays (db/fre/height/index, C row layout)."""

    __slots__ = ("db", "fre", "h", "idx")

    def __init__(self, db=(), fre=(), h=(), idx=()):
        self.db = list(db)
        self.fre = list(fre)
        self.h = list(h)
        self.idx = list(idx)

    def append_from(self, other, j):
        self.db.append(other.db[j])
        self.fre.append(other.fre[j])
        self.h.append(other.h[j])
        self.idx.append(other.idx[j])

    def copy(self):
        return _Row(self.db, self.fre, self.h, self.idx)

    def __len__(self):
        return len(self.db)


def _corrsort(row: _Row, key: str, count: int, asc: bool, start: int = 0):
    """__vcorrsort1 over row[start:start+count] (selection sort, C order)."""
    keys = getattr(row, key)
    idx = list(range(start, start + count))
    for a in range(len(idx)):
        for b in range(a + 1, len(idx)):
            ka, kb = keys[idx[a]], keys[idx[b]]
            if (ka > kb) if asc else (ka < kb):
                idx[a], idx[b] = idx[b], idx[a]
    for name in ("db", "fre", "h", "idx"):
        arr = getattr(row, name)
        vals = [arr[j] for j in idx]
        arr[start:start + count] = vals


def _max_index(arr, length):
    if not length:
        return 0
    index = 0
    value = arr[0]
    for i in range(1, length):
        if value < arr[i]:
            value = arr[i]
            index = i
    return index


def _is_low_fre(row: _Row, length) -> int:
    """__isLowFre (_pitch_ffp.c:2855)."""
    num = 0
    for i in range(length - 1):
        if row.fre[i] < 600:
            if (row.h[i] > 15 and row.h[i + 1] > 15
                    and row.fre[i + 1] - row.fre[i] > 30):
                if row.idx[i + 1] - row.idx[i] < 8:
                    num += 1
        else:
            break
    return 1 if num >= 4 else 0


def _arr_rectify(row: _Row, length) -> int:
    """__arr_rectify (_pitch_ffp.c:2957): drop a twin of the top peak."""
    if length < 3:
        return length
    db, fre = row.db, row.fre

    def drop(offset):
        for name in ("db", "fre", "h", "idx"):
            arr = getattr(row, name)
            del arr[offset]
            arr.append(0.0 if name != "idx" else 0)

    if abs(row.idx[0] - row.idx[1]) <= 4 and db[0] - db[1] < 3:
        s1 = abs(2 * fre[0] - fre[2])
        s2 = abs(2 * fre[1] - fre[2])
        drop(1 if s1 < s2 else 0)
        return length - 1
    elif abs(row.idx[1] - row.idx[2]) <= 4 and db[1] - db[2] < 3:
        if fre[0] > fre[1]:
            s1 = abs(2 * fre[1] - fre[0])
            s2 = abs(2 * fre[2] - fre[0])
        else:
            s1 = abs(fre[1] - 2 * fre[0])
            s2 = abs(fre[2] - 2 * fre[0])
        drop(2 if s1 < s2 else 1)
        return length - 1
    elif abs(row.idx[0] - row.idx[2]) <= 4 and db[0] - db[2] < 3:
        s1 = abs(2 * fre[0] - fre[1])
        s2 = abs(2 * fre[2] - fre[1])
        drop(2 if s1 < s2 else 0)
        return length - 1
    return length


def _is_light(x) -> float:
    """__isLight (_pitch_ffp.c:2897)."""
    if len(x) == 0:
        return 0.0
    v = 20.0 * np.log10(np.abs(np.asarray(x, np.float32)) + 1e-8)
    if np.any(v > -18):
        return 0.0
    count = int(np.sum(v > -24))
    return 1.0 * (len(x) - count) / len(x)


def _temporal(x, base) -> tuple:
    """__temproal (_pitch_ffp.c:2923): (max, avg, percent) of the frame's
    dB envelope floored at -36."""
    if len(x) == 0:
        return 0.0, 0.0, 0.0
    v = 20.0 * np.log10(np.abs(np.asarray(x, np.float32)) + 1e-8)
    v = np.maximum(v, -36.0)
    count = int(np.sum(v > -base))
    return (float(np.max(v)), float(np.sum(v) / len(x)),
            1.0 * (len(x) - count) / len(x))


class FFPChain:
    """Per-frame candidate sets of the C PitchFFP object."""

    def __init__(self, samplate=32000, low_fre=27.0, high_fre=4000.0,
                 radix2_exp=12, slide_length=None,
                 window_type=WindowType.HAMM, device=None):
        self.device = resolve_device(device)
        if not (27 <= low_fre < high_fre < samplate / 2):
            low_fre, high_fre = 27.0, 4000.0
        fft_length = 1 << radix2_exp
        self.samplate = samplate
        self.fft_length = fft_length
        self.slide_length = slide_length if slide_length else fft_length // 4
        self.window_type = WindowType(window_type)
        self.window = get_fft_window(self.window_type, fft_length)
        self._window_t = as_tensor(self.window, self.device)
        self.min_index = int(math.floor(low_fre * fft_length / samplate))
        self.max_index = min(int(math.ceil(high_fre * fft_length / samplate)),
                             fft_length // 2 - 1)
        if self.min_index >= self.max_index:
            self.min_index = 3
            self.max_index = int(math.ceil(4000 * fft_length / samplate))
        self.peak_length = (self.max_index - self.min_index) // 2 + 1
        self._correct = correct_fn(self.window_type)

    def cal_time_length(self, n: int) -> int:
        if n < self.fft_length:
            return 0
        return (n - self.fft_length) // self.slide_length + 1

    # -- stage 1: STFT + peak extraction (:2286) -----------------------
    def exec(self, x):
        x = host_f32(x)
        if x.ndim != 1:
            raise ValueError("PitchFFP expects a single (n,) signal")
        frames = frame_signal(as_tensor(x, self.device), self.fft_length,
                              self.slide_length)
        spec = afft.rfft(frames * self._window_t, dim=-1)
        power = (spec.real ** 2 + spec.imag ** 2).cpu().numpy().astype(
            np.float64)
        del spec
        s, e = self.min_index, self.max_index
        P = power[..., s:e + 1]
        dB = 10.0 * np.log10(np.maximum(P, 1e-30)
                             / self.fft_length / self.fft_length)
        scale = self._peak_scale(P)
        T = dB.shape[0]
        self.peaks = []      # raw peak rows (fre-asc after filterHeight)
        self.low_flag = []
        self.max_db = []
        for i in range(T):
            row, length = self._find_peaks(dB[i], P[i], scale[i])
            self.low_flag.append(_is_low_fre(row, length))
            _corrsort(row, "db", length, asc=False)
            length = _arr_rectify(row, length)
            row.db = row.db[:length]
            row.fre = row.fre[:length]
            row.h = row.h[:length]
            row.idx = row.idx[:length]
            self.max_db.append(row.db[0] if length else 0.0)
            self.peaks.append(row)
        # temporal lightness + envelope stats (:2588)
        self.light = []
        self.temporal_max = []
        self.temporal_avg = []
        self.temporal_percent = []
        base = getattr(self, "temp_base", 0.0)
        for i in range(T):
            seg = x[i * self.slide_length:
                    i * self.slide_length + self.fft_length]
            self.light.append(_is_light(seg))
            mx, avg, pct = _temporal(seg, base)
            self.temporal_max.append(mx)
            self.temporal_avg.append(avg)
            self.temporal_percent.append(pct)
        # filter chain -> level-1 set (getCorrData)
        self.filter3 = self._filter_chain()
        return self

    def _peak_scale(self, P):
        """The window correction's fractional bin of every interior bin j
        of the (T, bins) float64 power ``P``, taken as a peak between bins
        j - 1 and j + 1: the float32 correction of the float32 roundings
        of the float64 magnitudes, the neighbour picked on the float64
        ones.  Host code (torch on the CPU); 0 at the edge bins."""
        m = np.sqrt(P)
        cur, left, right = m[:, 1:-1], m[:, :-2], m[:, 2:]

        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32))
        det, _ = self._correct(f32(cur), f32(left), f32(right),
                               cond=torch.from_numpy(right >= left))
        scale = np.zeros(P.shape, np.float64)
        scale[:, 1:-1] = det.numpy()
        return scale

    def _find_peaks(self, db, p, scale_row):
        r_len = len(db)
        row = _Row()
        j = 1
        length = 0
        while j < r_len - 1:
            pre_p, cur_p, nex_p = p[j - 1], p[j], p[j + 1]
            if not (cur_p > pre_p and cur_p > nex_p):
                j += 1
                continue
            x_flag = e_flag = e_flag2 = 0
            _index = j + 1
            scale = scale_row[j]
            fre = ((j + self.min_index + float(scale))
                   / self.fft_length * self.samplate)
            _db = db[j]
            pre, cur, nex = db[j - 1], db[j], db[j + 1]
            left = pre
            _left = left
            if j - 2 >= 0:
                left = db[j - 2]
                _left = left
                if (left < pre or (left > pre and left < cur
                                   and left - pre < 2 and cur > _CUT_DB)):
                    if j - 3 >= 0:
                        pre3 = db[j - 3]
                        if pre3 < left:
                            left = pre3
                            _left = left
                            if (db[j - 2] > db[j - 1] and db[j - 2] < cur
                                    and db[j - 2] - db[j - 1] < 2):
                                x_flag = 1
                            if (j - 4 >= 0 and _db - left < _MIN_HEIGHT
                                    and cur > _CUT_DB2):
                                if db[j - 4] < pre3:
                                    left = db[j - 4]
                                    e_flag = 1
                else:
                    left = pre
                    _left = left
            right = nex
            _right = right
            if j + 2 < r_len:
                right = db[j + 2]
                _right = right
                if (right < nex or (right > nex and right < cur
                                    and right - nex < 2 and cur > _CUT_DB)):
                    if j + 3 < r_len:
                        nex3 = db[j + 3]
                        if nex3 < right:
                            right = nex3
                            _right = right
                            _index = j + 3
                            if (j + 4 < r_len and _db - right < _MIN_HEIGHT
                                    and not e_flag and cur > _CUT_DB2):
                                if db[j + 4] < nex3:
                                    right = db[j + 4]
                                    _index = j + 4
                                    e_flag2 = 1
                        else:
                            _index = j + 2
                else:
                    right = nex
                    _right = right
                    _index = j + 1
            h1, h2 = _db - left, _db - right
            height = min(h1, h2)
            if height > _MIN_HEIGHT and x_flag and h1 < h2 and length:
                row.db[length - 1] = _db
                row.fre[length - 1] = fre
                row.h[length - 1] = height
                row.idx[length - 1] = j
            else:
                if (e_flag or e_flag2) and cur < _CUT_DB \
                        and height < _MIN_HEIGHT + 3:
                    h1 = _db - _left
                    h2 = _db - _right
                    height = min(h1, h2)
                row.db.append(_db)
                row.fre.append(fre)
                row.h.append(height)
                row.idx.append(j)
                length += 1
            j = _index + 1 if _index >= j else j + 1
        return row, length

    # -- stage 2: filter chain height/near/dB/relation (:1360) ---------
    def _filter_chain(self):
        from audioflux_torch.mir._queue_util import queue_fre2
        out = []
        for i, row in enumerate(self.peaks):
            length = len(row)
            # --- filterHeight (:1370) ---
            f1 = _Row()
            if length >= 2:
                start = 2
            elif length >= 1:
                start = 1
            else:
                start = 0
            first_index = row.idx[0] if length >= 1 else 0
            second_index = row.idx[1] if length >= 2 else 0
            for j in range(start):
                f1.append_from(row, j)
            if self.low_flag[i]:
                for j in range(start, length):
                    if row.h[j] > _MIN_HEIGHT:
                        f1.append_from(row, j)
            else:
                _corrsort(row, "fre", length - start, asc=True, start=start)
                for j in range(start, length - 1):
                    if row.h[j] <= _MIN_HEIGHT:
                        continue
                    cur_db, pre_db, nex_db = (row.db[j], row.db[j - 1],
                                              row.db[j + 1])
                    cur_h = row.h[j]
                    pre_h, nex_h = row.h[j - 1], row.h[j + 1]
                    cur_i, pre_i, nex_i = (row.idx[j], row.idx[j - 1],
                                           row.idx[j + 1])
                    if first_index and pre_i < first_index < cur_i:
                        pre_h = _MIN_HEIGHT + 1
                    if second_index and pre_i < second_index < cur_i:
                        pre_h = _MIN_HEIGHT + 1
                    if first_index and cur_i < first_index < nex_i:
                        nex_h = _MIN_HEIGHT + 1
                    if second_index and cur_i < second_index < nex_i:
                        nex_h = _MIN_HEIGHT + 1
                    flag = 0
                    if cur_db > -60:
                        if ((cur_db - pre_db > 12 or pre_h > _MIN_HEIGHT)
                                and (cur_db - nex_db > 12
                                     or nex_h > _MIN_HEIGHT)):
                            flag = 1
                    else:
                        base = 12 if cur_h <= _MIN_HEIGHT + 4 else 11
                        if ((cur_db - pre_db > base
                             or (pre_h > _MIN_HEIGHT
                                 and cur_i - pre_i > 3))
                                and (cur_db - nex_db > base
                                     or (nex_h > _MIN_HEIGHT
                                         and nex_i - cur_i > 3))):
                            flag = 1
                    if flag:
                        f1.append_from(row, j)
            _corrsort(row, "fre", length, asc=True)
            _corrsort(f1, "fre", len(f1), asc=True)

            # --- filterNear (:1586) ---
            f2 = _Row()
            len1 = len(f1)
            last_flag = 1
            j = 0
            while j < len1 - 1:
                _index = j
                cur_fre, nex_fre = f1.fre[j], f1.fre[j + 1]
                if nex_fre - cur_fre < 30:
                    cur_db, nex_db = f1.db[j], f1.db[j + 1]
                    if j == len1 - 2:
                        last_flag = 0
                    if cur_db < nex_db:
                        _index = j + 1
                        if j + 2 < len1:
                            if (f1.fre[j + 2] - nex_fre < 30
                                    and nex_db > f1.db[j + 2]):
                                j += 1
                    j += 1
                f2.append_from(f1, _index)
                j += 1
            if last_flag and len1:
                f2.append_from(f1, len1 - 1)

            # --- filterDB (:1759) ---
            f3 = _Row()
            for j in range(len(f2)):
                if f2.db[j] > -100:
                    f3.append_from(f2, j)
            # three-continue jump (>19.5)
            g = _Row()
            j = 0
            while j < len(f3):
                g.append_from(f3, j)
                if j + 4 < len(f3):
                    d1, d2, d3, d4, d5 = (f3.db[j], f3.db[j + 1],
                                          f3.db[j + 2], f3.db[j + 3],
                                          f3.db[j + 4])
                    if (d1 - d2 > 19.5 and d1 - d3 > 19.5
                            and d1 - d4 > 19.5 and d5 - d2 > 19.5
                            and d5 - d3 > 19.5 and d5 - d4 > 19.5):
                        j += 3
                j += 1
            # two-continue jump (>14.5)
            f3 = _Row()
            j = 0
            while j < len(g):
                f3.append_from(g, j)
                if j + 3 < len(g):
                    d1, d2, d3, d4 = (g.db[j], g.db[j + 1], g.db[j + 2],
                                      g.db[j + 3])
                    if (d1 - d2 > 14.5 and d1 - d3 > 14.5
                            and d4 - d2 > 14.5 and d4 - d3 > 14.5):
                        j += 2
                j += 1
            len3 = len(f3)
            out_row = _Row()
            start = 0
            _index = _max_index(f3.db, len3)
            if _index > 6:
                _index = 0
            max_db = self.max_db[i]
            # C reads/copies one calloc'd zero entry past len3 when the
            # frame has no candidates (loop runs to _index=0 regardless)
            for j in range(_index + 1):
                dbj = f3.db[j] if j < len3 else 0.0
                if max_db - dbj < 14.5 or dbj > -42:
                    start = j
                    if j < len3:
                        out_row.append_from(f3, j)
                    else:
                        out_row.db.append(0.0)
                        out_row.fre.append(0.0)
                        out_row.h.append(0.0)
                        out_row.idx.append(0)
            for j in range(start + 1, len3 - 1):
                if (f3.db[j - 1] - f3.db[j] < 14.5
                        or f3.db[j + 1] - f3.db[j] < 14.5):
                    out_row.append_from(f3, j)
            if len3 > 1 and start < len3 - 1:
                if (f3.db[len3 - 2] - f3.db[len3 - 1] < 14.5
                        or len3 in (2, 3)):
                    out_row.append_from(f3, len3 - 1)

            # --- filterRelation (:1984) ---
            len3 = len(out_row)
            index1 = _max_index(out_row.db, len3)
            flag = 0
            start = end = 0
            if len3 > index1 + 1 and len3 >= 12:
                if (index1 <= 1
                        and 190 < out_row.fre[index1] < 205):
                    _, k1, k2 = queue_fre2(out_row.fre[index1],
                                           out_row.fre[index1 + 1])
                    if k1 == 1 and k2 == 2:
                        start = index1 + 1
                        for j in range(start + 1, len3):
                            if (out_row.db[start] - out_row.db[j] > 24):
                                _, k1, k2 = queue_fre2(out_row.fre[index1],
                                                       out_row.fre[j])
                                if k1 == 1:
                                    end = j
                                    break
                            else:
                                end = j
                                break
                    if 1 < end - start < 4:
                        flag = 1
            if flag:
                for name in ("db", "fre", "h", "idx"):
                    arr = getattr(out_row, name)
                    k = end
                    j = start + 1
                    while j < len3 and k < len3:
                        arr[j] = arr[k]
                        j += 1
                        k += 1
                    del arr[len3 - (end - start) + 1:]
            out.append(out_row)
        return out


def _gf(arr, i):
    return arr[i] if 0 <= i < len(arr) else 0.0


def _gi(arr, i):
    return arr[i] if 0 <= i < len(arr) else 0


class _FFPFast:
    """Fast/cut chain mixin split out for readability."""


def _preprocess(self, i):
    """__pitchFFPObj_preprocess (:512): per-frame dominant bin indices.

    Sorts the peak row dB-desc, dedups a near-top twin, then runs the
    string-register rules; re-sorts the row fre-asc before returning.
    Returns the dom bin-index list.
    """
    from audioflux_torch.mir._queue_util import queue_fre2
    row = self.peaks[i]
    _len = len(row)
    ref_len = len(self.filter3[i])
    dom = []
    _corrsort(row, "db", _len, asc=False)
    if abs(_gf(row.fre, 0) - _gf(row.fre, 1)) > 30:
        _offset = 0
        ln = _len
    else:
        _offset = 1
        ln = _len - 1
    db = [_gf(row.db, 0)] + [_gf(row.db, k + _offset)
                             for k in range(1, _len - _offset)]
    fre = [_gf(row.fre, 0)] + [_gf(row.fre, k + _offset)
                               for k in range(1, _len - _offset)]
    hei = [_gf(row.h, 0)] + [_gf(row.h, k + _offset)
                             for k in range(1, _len - _offset)]
    idx = [_gi(row.idx, 0)] + [_gi(row.idx, k + _offset)
                               for k in range(1, _len - _offset)]
    index1, index2 = _gi(idx, 0), _gi(idx, 1)
    fre1, fre2 = _gf(fre, 0), _gf(fre, 1)
    index3, index4, index5 = _gi(idx, 2), _gi(idx, 3), _gi(idx, 4)
    fre3, fre4, fre5 = _gf(fre, 2), _gf(fre, 3), _gf(fre, 4)
    dom.append(index1)
    dom.append(index2)
    if index1 > index2:
        fre1, fre2 = fre2, fre1
        index1, index2 = index2, index1

    mh = _MIN_HEIGHT
    _, k1, k2 = queue_fre2(fre1, fre2)
    if (k1 == 1 and k2 == 2
            and (abs(fre1 * 2 - fre2) < 5
                 or (100 < fre1 < 120 and abs(fre1 * 2 - fre2) < 15)
                 or (140 < fre1 < 155 and abs(fre1 * 2 - fre2) < 10))):
        # string-5, 1-24-5/7
        if 100 < fre3 < 120 and index3 < index1 and index3 < index2:
            _, k1, k2 = queue_fre2(fre3, fre1)
            if k1 == 1 and k2 == 2 and abs(fre3 * 2 - fre1) < 4:
                dom.append(_gi(idx, 2))
                if (fre4 > fre2 and _gf(hei, 3) > 12
                        and (abs(fre3 * 5 - fre4) < 5
                             or abs(fre3 * 7 - fre4) < 5)):
                    dom.append(_gi(idx, 3))
        elif 100 < fre1 < 120:
            _count = 0
            for k in range(2, ln):
                if _gf(fre, k) > fre2:
                    _, k1, k2 = queue_fre2(fre2 / 2, _gf(fre, k))
                    if (k1 == 1 and k2 in (3, 4, 5)
                            and abs(fre2 / 2 * k2 - _gf(fre, k)) < 5):
                        dom.append(_gi(idx, k))
                    _count += 1
                    if _count >= 3:
                        break
        # ->236, low65~75
        if (index3 < index1 and _gi(idx, 0) < _gi(idx, 1)
                and ((_gf(hei, 0) > mh and _gf(hei, 1) > mh)
                     or (_gf(hei, 0) > mh + 3
                         and _gf(hei, 1) > mh - 2))):
            if 130 < fre3 < 150:
                _, k1, k2 = queue_fre2(fre3, fre1)
                if (k1 == 2 and k2 == 3
                        and abs(fre3 / k1 * k2 - fre1) < 5):
                    if ref_len >= 3:
                        dom.append(_gi(idx, 2))
            else:
                if (index4 < index1 and _gi(idx, 0) < _gi(idx, 1)
                        and index4 > index3
                        and _gf(db, 2) - _gf(db, 3) < 2):
                    if 90 < fre3 < 110 and 130 < fre4 < 150:
                        _, k1, k2 = queue_fre2(fre4, fre1)
                        if (k1 == 2 and k2 == 3
                                and abs(fre4 / k1 * k2 - fre1) < 5):
                            if ref_len >= 3:
                                dom.append(_gi(idx, 3))
        # ->234, low50~60
        if (100 < fre1 < 120
                and ((_gf(hei, 0) > mh and _gf(hei, 1) > mh)
                     or (_gf(hei, 0) > mh + 3
                         and _gf(hei, 1) > mh - 2))):
            _count = 0
            for k in range(2, ln):
                if (150 < _gf(fre, k) < 180
                        and index1 < _gi(idx, k) < index2):
                    _, k1, k2 = queue_fre2(fre1, _gf(fre, k))
                    if (k1 == 2 and k2 == 3
                            and abs(fre1 / k1 * k2 - _gf(fre, k)) < 5):
                        if ref_len >= 3:
                            dom.append(_gi(idx, k))
                    _count += 1
                    if _count >= 3:
                        break
        # ->123, 147+7
        if 140 < fre1 < 154 and _gi(idx, 0) > _gi(idx, 1):
            _count = 0
            for k in range(2, ln):
                if _gf(fre, k) > fre2:
                    _, k1, k2 = queue_fre2(fre1, _gf(fre, k))
                    if (k1 == 1 and k2 in (3, 4)
                            and (abs(fre1 * k2 - _gf(fre, k)) < 5
                                 or abs(fre1 - _gf(fre, k) / k2) < 3)):
                        dom.append(_gi(idx, k))
                    _count += 1
                    if _count >= 3:
                        break
        # ->234, 80 ->75~90
        if 75 < fre1 < 90:
            for k in range(2, ln):
                if _gf(fre, k) > fre2:
                    _, k1, k2 = queue_fre2(fre2, _gf(fre, k))
                    if k1 == 2 and k2 == 3:
                        dom.append(_gi(idx, k))
                    break

    _, k1, k2 = queue_fre2(fre1, fre2)
    if k1 == 1 and k2 == 3 and abs(fre1 * 3 - fre2) < 5:
        # string-6, 1267
        if 140 < _gf(fre, 0) < 170 and _gi(idx, 0) < _gi(idx, 1):
            _, k1, k2 = queue_fre2(fre3, _gf(fre, 0))
            if (k1 == 1 and k2 == 2
                    and abs(fre3 * 2 - _gf(fre, 0)) < 4):
                if _gf(hei, 0) > mh and _gf(hei, 1) > mh:
                    dom.append(_gi(idx, 2))

    # string-6, x23x, 80+5
    if 150 < _gf(fre, 0) < 170 and _gi(idx, 0) > _gi(idx, 1):
        _count = 0
        for k in range(2, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(_gf(fre, 0) / 2, _gf(fre, k))
                if (k1 == 1 and k2 == 3
                        and (abs(_gf(fre, 0) / 2 * k2 - _gf(fre, k)) < 4
                             or (k == 2
                                 and abs(_gf(fre, 0) / 2 * k2
                                         - _gf(fre, k)) < 5))):
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 3:
                    break

    _, k1, k2 = queue_fre2(fre1, fre2)
    if (150 < _gf(fre, 0) < 170 and k1 == 2 and k2 == 3
            and fre3 < _gf(fre, 0)):
        _, k1, k2 = queue_fre2(fre3, _gf(fre, 0))
        if k1 == 1 and k2 == 2 and abs(fre3 * 2 - _gf(fre, 0)) < 4:
            dom.append(_gi(idx, 2))
        elif (fre4 < _gf(fre, 0) and _gf(db, 2) - _gf(db, 3) < 3
              and _gi(idx, 2) - _gi(idx, 3) <= 3):
            _, k1, k2 = queue_fre2(fre4, _gf(fre, 0))
            if abs(fre4 * 2 - _gf(fre, 0)) < 4:
                dom.append(_gi(idx, 3))

    _, k1, k2 = queue_fre2(fre1, fre2)
    if 150 < _gf(fre, 0) < 170 and k1 == 1 and k2 == 3:
        if fre3 > _gf(fre, 0):
            _, k1, k2 = queue_fre2(_gf(fre, 0), fre3)
            if (k1 == 2 and k2 == 3
                    and abs(_gf(fre, 0) / 2 - fre3 / 3) < 5):
                dom.append(_gi(idx, 2))
        else:
            _, k1, k2 = queue_fre2(fre3, _gf(fre, 0))
            if (k1 == 1 and k2 == 2
                    and abs(fre3 * 2 - _gf(fre, 0)) < 5):
                dom.append(_gi(idx, 2))

    if 150 < _gf(fre, 0) < 170:
        _count = 0
        for k in range(1, ln):
            if _gf(fre, k) > _gf(fre, 0):
                if abs(_gf(fre, 0) / 2 - _gf(fre, k) / 3) < 5:
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 3:
                    break

    # string-5, 1x23, 110+10
    if (100 < _gf(fre, 0) < 120 and _gi(idx, 0) < _gi(idx, 1)
            and ref_len > 3):
        _count = 0
        for k in range(1, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(_gf(fre, 0), _gf(fre, k))
                if k1 == 1 and k2 in (2, 3, 4):
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 3:
                    break

    _, k1, k2 = queue_fre2(fre1, fre2)
    if (100 < _gf(fre, 0) / 2 < 120 and _gi(idx, 0) > _gi(idx, 1)
            and k1 == 1 and k2 == 2):
        _count = 0
        for k in range(1, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(_gf(fre, 0) / 2, _gf(fre, k))
                if k1 == 1 and k2 in (3, 4):
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 2:
                    break

    _, k1, k2 = queue_fre2(fre1, fre2)
    if (315 < _gf(fre, 0) < 345 and _gi(idx, 0) > _gi(idx, 1)
            and k1 == 1 and k2 == 3):
        _count = 0
        for k in range(1, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(fre1, _gf(fre, k))
                if k1 == 1 and k2 == 4:
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 1:
                    break

    if (200 < _gf(fre, 0) < 240 and _gi(idx, 0) < _gi(idx, 1)
            and k1 == 1 and k2 == 2 and abs(fre1 * 2 - fre2) < 5):
        _count = 0
        for k in range(2, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(fre1, _gf(fre, k))
                if k1 == 2 and k2 == 3:
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 2:
                    break

    if (200 < _gf(fre, 0) < 240 and _gi(idx, 0) > _gi(idx, 1)
            and k1 == 1 and k2 == 2 and abs(fre1 * 2 - fre2) < 5):
        _count = 0
        for k in range(2, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(fre1, _gf(fre, k))
                if k1 == 2 and k2 == 3:
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 2:
                    break

    # string-4, x123/x136/x1x2, 147+7
    if 140 < _gf(fre, 0) < 154 and _gi(idx, 0) > _gi(idx, 1):
        _count = 0
        for k in range(2, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(_gf(fre, 0), _gf(fre, k))
                if (k1 == 1 and k2 in (2, 3)
                        and abs(_gf(fre, 0) * k2 - _gf(fre, k)) < 5):
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 3:
                    break

    if 280 < _gf(fre, 0) < 310:
        _count = 0
        for k in range(1, ln):
            if _gf(fre, k) < _gf(fre, 0):
                _, k1, k2 = queue_fre2(_gf(fre, k), _gf(fre, 0))
                if (k1 == 1 and k2 == 2
                        and abs(_gf(fre, k) * k2 - _gf(fre, 0)) < 8):
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 2:
                    break
        _count = 0
        for k in range(1, ln):
            if _gf(fre, k) > _gf(fre, 0):
                _, k1, k2 = queue_fre2(_gf(fre, 0) / 2, _gf(fre, k))
                if (k1 == 1 and k2 in (3, 4)
                        and abs(_gf(fre, 0) / 2 * k2 - _gf(fre, k)) < 5):
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 3:
                    break

    # string-3, x13x, 197+7
    if ((190 < _gf(fre, 0) < 204 and _gi(idx, 0) > _gi(idx, 1))
            or (_gf(fre, 1) > 190 and _gf(fre, 0) < 204
                and _gf(db, 0) - _gf(db, 1) < 3
                and _gi(idx, 0) < _gi(idx, 1))):
        _count = 0
        _fre = (_gf(fre, 0) if 190 < _gf(fre, 0) < 204
                else _gf(fre, 1))
        for k in range(2, ln):
            if _gf(fre, k) > _fre:
                _, k1, k2 = queue_fre2(_fre, _gf(fre, k))
                if (k1 == 1 and k2 in (2, 3)
                        and abs(_fre * k2 - _gf(fre, k)) < 4):
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 3:
                    break

    # string-2, 123, 247 -> >220
    _, k1, k2 = queue_fre2(fre1, fre2)
    if (_gf(fre, 0) > 220 and _gi(idx, 0) < _gi(idx, 1)
            and k1 == 1 and k2 == 2 and abs(fre1 * 2 - fre2) < 5
            and ref_len > 3):
        _count = 0
        for k in range(2, ln):
            if _gf(fre, k) > _gf(fre, 1):
                _, k1, k2 = queue_fre2(_gf(fre, 0), _gf(fre, k))
                if k1 == 1 and k2 == 3:
                    dom.append(_gi(idx, k))
                _count += 1
                if _count >= 2:
                    break

    _corrsort(row, "fre", _len, asc=True)
    return dom


FFPChain._preprocess = _preprocess


def _filter_fast(self):
    """__pitchFFPObj_filterFast (:1228) + fastDB (:2065) + fastCut (:2217).

    -> (fast3_rows, fast4_rows); also re-runs preprocess per frame (the C
    does, mutating the peak-row order transiently)."""
    fast3_rows, fast4_rows = [], []
    f2_rows = []
    dom = []
    for i, row in enumerate(self.peaks):
        dom = self._preprocess(i)
        length = len(row)
        # --- fast near-merge over qualifying peaks ---
        f2 = _Row()
        j = 0
        while j < length:
            if not (row.h[j] > _MIN_HEIGHT or row.idx[j] in dom):
                j += 1
                continue
            cur_fre, cur_db = row.fre[j], row.db[j]
            nex_fre = 0.0
            nex_db = 0.0
            _index = 0
            for k in range(j + 1, length):
                if row.h[k] > _MIN_HEIGHT or row.idx[k] in dom:
                    nex_fre, nex_db = row.fre[k], row.db[k]
                    _index = k
                    break
            if nex_fre:
                if nex_fre - cur_fre < 30:
                    f2.append_from(row, _index if cur_db < nex_db else j)
                    j = _index
                else:
                    f2.append_from(row, j)
            else:
                f2.append_from(row, j)
            j += 1
        f2_rows.append(f2)
    # fastDB/fastCut run AFTER the frame loop in the C, so their dom
    # membership test sees the LAST frame's domIndexArr (stale global)
    dom_last = dom
    for i, f2 in enumerate(f2_rows):
        # --- fastDB (:2065) ---
        f3 = _Row()
        for j in range(len(f2)):
            if f2.db[j] > -100:
                f3.append_from(f2, j)
        g = _Row()
        j = 0
        while j < len(f3):
            g.append_from(f3, j)
            if j + 3 < len(f3):
                d1, d2, d3, d4 = (f3.db[j], f3.db[j + 1], f3.db[j + 2],
                                  f3.db[j + 3])
                if (d1 - d2 > 15 and d1 - d3 > 15
                        and d4 - d2 > 15 and d4 - d3 > 15):
                    j += 2
            j += 1
        len2 = len(g)
        out = _Row()
        start = 0
        _index = _max_index(g.db, len2)
        max_db = self.max_db[i]
        for j in range(_index + 1):
            dbj = g.db[j] if j < len2 else 0.0
            hj = g.h[j] if j < len2 else 0.0
            ij = g.idx[j] if j < len2 else 0
            if (max_db - dbj < 15 or dbj > -60
                    or hj > 18 or ij in dom_last):
                start = j
                if j < len2:
                    out.append_from(g, j)
                else:
                    out.db.append(0.0)
                    out.fre.append(0.0)
                    out.h.append(0.0)
                    out.idx.append(0)
        for j in range(start + 1, len2 - 1):
            if g.db[j - 1] - g.db[j] < 15 or g.db[j + 1] - g.db[j] < 15:
                out.append_from(g, j)
        if len2 > 1 and start < len2 - 1:
            # C: `len2==3||len3==2` (len3 = the running output count)
            if (g.db[len2 - 2] - g.db[len2 - 1] < 15
                    or len2 == 3 or len(out) == 2):
                out.append_from(g, len2 - 1)
        # --- fastCut (:2217): top-4 by dB, fre-asc ---
        # The C copies a FIXED 4 entries from the dB-desc-sorted fast3
        # buffer, reading past len3 into the stale remnants of the earlier
        # in-place compaction stages (g beyond len3, f3 beyond len(g)).
        f3s = out.copy()
        _corrsort(f3s, "db", len(f3s), asc=False)
        buf = f3s.copy()
        for p in range(len(out), len(g)):
            buf.append_from(g, p)
        for p in range(len(g), len(f3)):
            buf.append_from(f3, p)
        f4 = _Row()
        for j in range(4):
            f4.db.append(_gf(buf.db, j))
            f4.fre.append(_gf(buf.fre, j))
            f4.h.append(_gf(buf.h, j))
            f4.idx.append(_gi(buf.idx, j))
        _corrsort(f4, "fre", 4, asc=True)
        _corrsort(f3s, "fre", len(f3s), asc=True)
        fast3_rows.append(f3s)
        fast4_rows.append(f4)
    return fast3_rows, fast4_rows


def _pitch(self, x):
    """pitchFFPObj_pitch (:279): full chain + trist3 resolution.

    -> (fre_arr, db_arr): per-frame fundamental and top-peak dB."""
    from audioflux_torch.mir._queue_util import trist3_resolve
    self.exec(x)
    fast3, fast4 = self._filter_fast()
    self.fast3, self.fast4 = fast3, fast4
    T = len(self.filter3)
    fre_out = np.zeros(T, np.float32)
    db_out = np.zeros(T, np.float32)
    flags = np.zeros(T, np.int32)
    for i in range(T):
        r1, r3, r5 = self.filter3[i], fast3[i], fast4[i]
        flag, fre = trist3_resolve(
            r1.fre, r1.db, r1.h, len(r1),
            r3.fre, r3.db, r3.h, len(r3),
            r5.fre, r5.db, r5.h, len(r5),
            self.light[i])
        fre_out[i] = fre
        flags[i] = flag
        db_out[i] = self.max_db[i]
    self.success_flags = flags
    return fre_out, db_out


FFPChain._filter_fast = _filter_fast
FFPChain.pitch = _pitch
