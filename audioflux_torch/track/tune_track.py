"""Real-time instrument tuner (exact port of the C state machine).

Counterpart of ``audioflux_tpu/track/tune_track.py``: the same state
machine on the host, over the port's components, each of which runs its
FFT (and YIN, HarmonicRatio and the spectrograms all their math) on the
plan's device; their results come to the host once a call.

Reference ``src/track/tune_track.c``: composes YIN (pitch + trough
candidates + CMND minimum), the frame-exact PitchFFP (pitch, filter/cut
candidate rows, lightness), HarmonicRatio, a harmonic counter and two
linear magnitude spectrograms (flatness + 0-400 Hz flux) with the
onset/entry/update/keep hysteresis state machine of
``tuneTrackObj_tune`` (:330-1275), including its per-band entry guards,
string-register corrections of the FFP estimate, and the in-place row
mutations of ``__isKeySimilar``.  All inputs are exact ports, so the
tracked output mirrors the C tuner.
"""

from __future__ import annotations

import math

import numpy as np

from audioflux_torch.mir._queue_util import cal_range_times, queue_fre2
from audioflux_torch.mir.harmonic import Harmonic
from audioflux_torch.mir.harmonic_ratio import HarmonicRatio
from audioflux_torch.mir.pitch_ffp import PitchFFP
from audioflux_torch.mir.pitch_yin import PitchYIN
from audioflux_torch.ops.backend import host_f32, resolve_device
from audioflux_torch.transforms.spectrogram import Spectrogram
from audioflux_torch.types import (SpectralDataType,
                                   SpectralFilterBankScaleType, WindowType)

__all__ = ["TuneTrack"]


def _fre_to_midi(f):
    if f <= 0:
        return -2147483648
    return int(math.floor(12 * math.log2(f / 440.0) + 69 + 0.5)) \
        if 12 * math.log2(f / 440.0) + 69 >= 0 else \
        -int(math.floor(-(12 * math.log2(f / 440.0) + 69) + 0.5))


def _is_similar(v1, v2):
    """__isSimilar (:1378): within one midi tone."""
    return 1 if abs(_fre_to_midi(v1) - _fre_to_midi(v2)) <= 1 else 0


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


def _corrsort2(key, other, count, asc):
    """__vcorrsort1 with two arrays (in-place over first count)."""
    for a in range(count):
        for b in range(a + 1, count):
            if (key[a] > key[b]) if asc else (key[a] < key[b]):
                key[a], key[b] = key[b], key[a]
                other[a], other[b] = other[b], other[a]


def _update_fre2(fre_arr, db_arr, height_arr, length, pre_fre, ref_fre):
    """__updateFre2 (:1408)."""
    if not length:
        return 0.0
    if abs(pre_fre - ref_fre) < 10:
        return ref_fre
    for i in range(length):
        if abs(fre_arr[i] - pre_fre) < 10:
            return fre_arr[i]
    _index = _max_index(db_arr, length)
    if height_arr[_index] > 15:
        for i in range(2, 10):
            if abs(fre_arr[_index] / i - pre_fre) < 10:
                return fre_arr[_index] / i
    return 0.0


def _update_fre(arr, length, value, yin, min_value, max_value):
    """__updateFre (:1447): nearest trough with asymmetric gates."""
    if not length:
        return 0.0
    sub = min_value
    if value > 220:
        sub = max_value
    sub2 = min_value if yin > 0.3 else 10.0
    error = 5000.0
    fre = 0.0
    _index = -1
    for i in range(length):
        _value = abs(arr[i] - value)
        if error > _value:
            error = _value
            fre = arr[i]
            _index = i
    flag = 0
    if arr[_index] > value:
        if error < sub:
            flag = 1
    else:
        if error < sub2:
            flag = 1
    return fre if flag else 0.0


def _compare_fre(arr, length, value):
    """__compareFre (:1515). -> (fre, index)."""
    fre = 0.0
    _index = -1
    error = 100.0
    for i in range(length):
        _value = abs(arr[i] - value)
        if _is_similar(arr[i], value):
            if error > _value:
                error = _value
                fre = arr[i]
                _index = i
    return fre, _index


def _is_key_similar(fre1, db1, len1, fre2, db2, len2):
    """__isKeySimilar (:1543).  Sorts the rows IN PLACE like the C."""
    flag = 0
    if len1 > 1 and len2 > 1 and len2 <= 6:
        _corrsort2(db1, fre1, len1, asc=False)
        _corrsort2(db2, fre2, len2, asc=False)
        if abs(db1[0] - db2[0]) > 5.6:
            return 0
        _corrsort2(fre1, db1, 2, asc=True)
        _corrsort2(fre2, db2, 2, asc=True)
        flag = 1
        for i in range(2):
            k, _ = cal_range_times(fre1[i], fre2[i])
            if k != 1:
                flag = 0
                break
        if not flag and len2 == 2 and len1 <= 3:
            _, k1, k2 = queue_fre2(fre1[0], fre1[1])
            if k1 == 1 and k2 == 2 and abs(fre1[0] * 2 - fre1[1]) < 5:
                if (fre2[0] > fre1[0] and fre2[0] - fre1[0] < 10
                        and fre2[1] > fre1[1] and fre2[1] - fre1[1] < 25):
                    flag = 1
        if not flag and len1 > 2 and len2 > 2:
            _corrsort2(fre1, db1, 3, asc=True)
            _corrsort2(fre2, db2, 3, asc=True)
            flag = 1
            for i in range(2):
                k, _ = cal_range_times(fre1[i], fre2[i])
                if k != 1:
                    flag = 0
                    break
    else:
        if len1 > 10 and len2 > 10:
            _corrsort2(db1, fre1, len1, asc=False)
            _corrsort2(db2, fre2, len2, asc=False)
            if (190 < fre1[0] < 204 and 190 < fre2[0] < 204):
                _corrsort2(fre1, db1, 2, asc=True)
                _corrsort2(fre2, db2, 2, asc=True)
                flag = 1
                for i in range(2):
                    k, _ = cal_range_times(fre1[i], fre2[i])
                    if k != 1:
                        flag = 0
                        break
    return flag


def _cal_flux(cur, pre, length):
    """__calFlux (:1668) with p=1, positive, no exp, sum."""
    value = 0.0
    for i in range(length):
        v1 = cur[i] - pre[i]
        value += v1 if v1 > 0 else 0.0
    return value


class TuneTrack:
    """API mirrors the C ``tuneTrackObj_*`` surface (tuneTrackObj_new
    defaults: yinThresh 0.6, inThresh 0.25, updateThresh 0.5, cutThresh
    0.6, inFluxThresh 110, delay 1, keep 4), plus ``device`` (``None``
    means ``cuda``).  The components run on the plan's device; the
    per-frame peak chains and the state machine run on the host."""

    def __init__(self, samplate=32000, low_fre=None, high_fre=None,
                 radix2_exp=12, slide_length=None, is_continue=False,
                 device=None):
        self.device = dev = resolve_device(device)
        fft_length = 1 << radix2_exp
        self.samplate = samplate
        self.radix2_exp = radix2_exp
        self.fft_length = fft_length
        self.slide_length = slide_length if slide_length else fft_length // 4

        ffp_kw = {}
        if low_fre is not None:
            ffp_kw["low_fre"] = low_fre
        if high_fre is not None:
            ffp_kw["high_fre"] = high_fre
        else:
            # C passes NULLs through: FFP/YIN then use their C defaults
            ffp_kw.setdefault("low_fre", 27.0)
            ffp_kw["high_fre"] = 4000.0
        self._ffp = PitchFFP(samplate=samplate, radix2_exp=radix2_exp,
                             slide_length=self.slide_length, device=dev,
                             **ffp_kw)
        yin_kw = {}
        if low_fre is not None:
            yin_kw["low_fre"] = low_fre
        if high_fre is not None:
            yin_kw["high_fre"] = high_fre
        self._yin = PitchYIN(samplate=samplate, radix2_exp=radix2_exp,
                             slide_length=self.slide_length, device=dev,
                             **yin_kw)
        self.yin_thresh = 0.6
        self._yin.set_thresh(self.yin_thresh)
        self._hr = HarmonicRatio(
            samplate=samplate,
            low_fre=low_fre if low_fre is not None else 25.0,
            radix2_exp=radix2_exp, slide_length=self.slide_length,
            window_type=WindowType.HAMM, device=dev)
        self._hm = Harmonic(samplate=samplate, radix2_exp=radix2_exp,
                            window_type=WindowType.HAMM,
                            slide_length=self.slide_length, device=dev)
        self._spec = Spectrogram(
            num=0, samplate=samplate, radix2_exp=radix2_exp,
            window_type=WindowType.HAMM, slide_length=self.slide_length,
            data_type=SpectralDataType.MAG,
            filter_bank_type=SpectralFilterBankScaleType.LINEAR, device=dev)
        self._spec2 = Spectrogram(
            num=0, samplate=samplate, low_fre=0.0, high_fre=400.0,
            radix2_exp=radix2_exp, window_type=WindowType.HAMM,
            slide_length=self.slide_length,
            data_type=SpectralDataType.MAG,
            filter_bank_type=SpectralFilterBankScaleType.LINEAR, device=dev)
        self.band_length = self._spec2.num

        # thresholds (tuneTrackObj_new:163-275)
        self.in_thresh = 0.25
        self.update_thresh = 0.5
        self.cut_thresh = 0.6
        self.in_flux_thresh = 110.0
        self.keep_length = 4
        self.updata_min_value = 5.0
        self.updata_max_value = 8.0
        self.clear()

    # -- streaming state ------------------------------------------------
    def clear(self):
        """tuneTrackObj_clear: reset tracking state."""
        self._index = 0
        self._onset_offset = 0
        self._in_flux_flag = 0
        self._delay_flux_length = 2
        self._delay_length = 1
        self._in_flag = 0
        self._keep_flag = 0
        self._anchor_fre = 0.0
        self._pre_fre = 0.0
        self._pre_db = 0.0
        self._pre_value = 0.0
        self._pre_flux = 0.0
        self._left_flux = 0.0
        self._pre_fre_arr = []
        self._pre_db_arr = []
        self._pre_length = 0
        self._pre_spec = np.zeros(self.band_length, np.float32)
        self._pre_count = 0
        self._pre_count2 = 0
        self._pre_fre2 = 0.0
        self._pre_fre3 = 0.0
        self._pre_fre4 = 0.0
        self._equal_count = 0

    def set_temp_base(self, temp_base: float):
        pass  # forwarded to FFP temporal in the C; no tuner effect

    def set_update_base(self, min_base: float, max_base: float):
        if min_base >= 1:
            self.updata_min_value = float(min_base)
        if max_base >= 1:
            self.updata_max_value = float(max_base)

    def cal_time_length(self, data_length: int) -> int:
        return self._ffp.cal_time_length(data_length)

    # -------------------------------------------------------------------
    def tune(self, data_arr):
        """(n,) -> per-frame tracked frequency (0 where no stable tone)."""
        x = host_f32(data_arr)
        T = self.cal_time_length(len(x))
        if T <= 0:
            return np.zeros(0, np.float32)
        cut_fre = 2000.0

        fre1, val1 = [a.cpu().numpy() for a in self._yin.pitch(x)]
        val2 = self._yin.get_min_data()
        m_fre_rows, _m_trough_rows, lens1 = self._yin.get_trough_data()
        fre2_arr, db_arr = self._ffp.pitch(x)
        fre2_arr = np.array(fre2_arr, np.float32)
        corr_rows = self._ffp.get_corr_data()    # filter3 _Row, mutable
        cut_rows = self._ffp.get_cut_data()      # fast4 _Row
        light = np.asarray(self._ffp.get_light_data())
        hr = self._hr.harmonic_ratio(x).cpu().numpy()
        self._hm.exec(x)
        counts = self._hm.count_range(80, 16000)
        spec = self._spec.spectrogram(x)
        ness = self._spec.flatness(self._spec.preprocess(spec)).cpu().numpy()
        del spec
        spec2 = self._spec2.spectrogram(x).cpu().numpy()  # (band, T)

        out = np.zeros(T, np.float32)
        flux_arr = np.zeros(T, np.float32)
        n_band = self.band_length

        for i in range(T):
            anchor_fre = 0.0
            self._index += 1
            if self._onset_offset:
                self._onset_offset += 1

            flux_arr[i] = _cal_flux(spec2[:, i], self._pre_spec, n_band)
            if not self._pre_flux:
                flux_arr[i] = 1e-5
            if self._in_flux_flag:
                self._in_flux_flag += 1
            else:
                if (flux_arr[i] < self._pre_flux
                        and self._pre_flux > self._left_flux
                        and self._pre_flux > self.in_flux_thresh
                        and (not self._onset_offset
                             or self._onset_offset > 5)):
                    self._delay_flux_length = (2 if flux_arr[i]
                                               > self._left_flux else 1)
                    self._in_flux_flag = 1
            if self._in_flux_flag == self._delay_flux_length:
                self._in_flux_flag = 0
                self._onset_offset = 1

            mf = list(m_fre_rows[i])
            n1 = int(lens1[i])
            c_row = corr_rows[i]
            n2 = len(c_row)
            k_row = cut_rows[i]
            n3 = len(k_row)
            v2 = float(val2[i])
            f2 = float(fre2_arr[i])
            db_i = float(db_arr[i])
            cnt = int(counts[i])

            if self._in_flag == self._delay_length + 1:  # runloop
                self._index = 0
                fre_out = 0.0
                if v2 < 0.2:  # <0.2 update
                    if (db_i - self._pre_db > 4
                            and not _is_key_similar(
                                self._pre_fre_arr, self._pre_db_arr,
                                self._pre_length, c_row.fre, c_row.db, n2)):
                        self._in_flag = 0
                        self._keep_flag = 0
                        self._anchor_fre = 0.0
                        fre_out = self._pre_fre
                    else:
                        if self._pre_fre < cut_fre:
                            fre_out = _update_fre(
                                mf, n1, self._pre_fre, v2,
                                self.updata_min_value,
                                self.updata_max_value)
                            if (not fre_out
                                    and 230 < self._pre_fre < 255
                                    and abs(self._pre_fre - f2) < 15):
                                fre_out = _update_fre(
                                    mf, n1, f2, v2,
                                    self.updata_min_value,
                                    self.updata_max_value)
                        else:
                            fre_out = _update_fre2(
                                c_row.fre, c_row.db, c_row.h, n2,
                                self._pre_fre, f2)
                        if fre_out:
                            self._pre_fre = fre_out
                            self._anchor_fre = 0.0
                            self._equal_count = 0
                        else:
                            anchor_fre = _update_fre(
                                mf, n1, self._anchor_fre, v2,
                                self.updata_min_value,
                                self.updata_max_value)
                            if anchor_fre:
                                fre_out = self._pre_fre
                                self._anchor_fre = anchor_fre
                            else:
                                fre_out = self._pre_fre
                                self._equal_count += 1
                elif v2 < self.update_thresh:  # 0.2~0.5 update
                    if (db_i - self._pre_db > 4
                            and not _is_key_similar(
                                self._pre_fre_arr, self._pre_db_arr,
                                self._pre_length, c_row.fre, c_row.db, n2)):
                        self._in_flag = 0
                        self._keep_flag = 0
                        self._anchor_fre = 0.0
                        fre_out = self._pre_fre
                    else:
                        if self._pre_fre < cut_fre:
                            fre_out = _update_fre(
                                mf, n1, self._pre_fre, v2,
                                self.updata_min_value,
                                self.updata_max_value)
                        else:
                            fre_out = _update_fre2(
                                c_row.fre, c_row.db, c_row.h, n2,
                                self._pre_fre, f2)
                        if not fre_out and v2 > 0.3:
                            if _is_similar(self._pre_fre, f2):
                                if abs(self._pre_fre - f2) < 6:
                                    fre_out = f2
                            else:
                                _is_similar(self._pre_fre, f2 / 2)
                                if abs(self._pre_fre - f2 / 2) < 6:
                                    fre_out = f2 / 2
                        if fre_out:
                            self._keep_flag = 0
                            self._pre_fre = fre_out
                            self._anchor_fre = 0.0
                            self._equal_count = 0
                        else:
                            anchor_fre = _update_fre(
                                mf, n1, self._anchor_fre, v2,
                                self.updata_min_value,
                                self.updata_max_value)
                            if anchor_fre:
                                fre_out = self._pre_fre
                                self._anchor_fre = anchor_fre
                            else:
                                fre_out = self._pre_fre
                                self._keep_flag += 1
                                if self._keep_flag > self.keep_length:
                                    self._in_flag = 0
                                    self._keep_flag = 0
                                    self._anchor_fre = 0.0
                                self._equal_count += 1
                else:  # keep / stop band
                    has_similar = v2 < self.cut_thresh
                    if db_i - self._pre_db > 4:
                        self._in_flag = 0
                        self._keep_flag = 0
                        self._anchor_fre = 0.0
                        fre_out = self._pre_fre
                    else:
                        if self._pre_fre < cut_fre:
                            fre_out = _update_fre(
                                mf, n1, self._pre_fre, v2,
                                self.updata_min_value,
                                self.updata_max_value)
                        else:
                            fre_out = _update_fre2(
                                c_row.fre, c_row.db, c_row.h, n2,
                                self._pre_fre, f2)
                        if not fre_out and has_similar:
                            if _is_similar(self._pre_fre, f2):
                                if abs(self._pre_fre - f2) < 6:
                                    fre_out = f2
                            else:
                                _is_similar(self._pre_fre, f2 / 2)
                                if abs(self._pre_fre - f2 / 2) < 6:
                                    fre_out = f2 / 2
                        if fre_out:
                            self._keep_flag = 0
                            if self._pre_fre < cut_fre:
                                fre_out = self._pre_fre
                            else:
                                self._pre_fre = fre_out
                            self._anchor_fre = 0.0
                            self._equal_count = 0
                        else:
                            anchor_fre = _update_fre(
                                mf, n1, self._anchor_fre, v2,
                                self.updata_min_value,
                                self.updata_max_value)
                            if anchor_fre:
                                fre_out = self._pre_fre
                                self._anchor_fre = anchor_fre
                            else:
                                fre_out = self._pre_fre
                                self._keep_flag += 1
                                if self._keep_flag > self.keep_length:
                                    self._in_flag = 0
                                    self._keep_flag = 0
                                    self._anchor_fre = 0.0
                                self._equal_count += 1
                out[i] = fre_out
            else:  # entry
                self._equal_count = 0
                sub_fre = 2.0
                if (v2 < self.in_thresh
                        and ((v2 < 0.1
                              and (cnt >= 3 if light[i] > 0.98 else True))
                             or (0.1 <= v2 < 0.2 and cnt >= 6
                                 and (ness[i] < 0.13 or hr[i] > 0.8))
                             or (v2 >= 0.2 and self._pre_value < 0.2
                                 and cnt >= 6
                                 and (ness[i] < 0.12 or hr[i] > 0.8)))
                        and f2):
                    self._in_flag += 1

                    if 215 < f2 < 225 and v2 < 0.1 and cnt <= 12:
                        if ((105 < self._pre_fre4 < 115)
                                or (105 < self._pre_fre3 < 115)):
                            f2 /= 2
                            fre2_arr[i] = f2
                    if 105 < self._pre_fre4 < 115:  # 110-147
                        if v2 < 0.1 and n2 > 10:
                            kf, kd = k_row.fre, k_row.db
                            if (105 < kf[0] < 115 and 140 < kf[1] < 155
                                    and kd[1] > kd[2] and kd[1] > kd[3]):
                                f2 = kf[1]
                                fre2_arr[i] = f2
                    elif 140 < self._pre_fre4 < 155:  # 147-196
                        if ((95 < f2 < 103 or 45 < f2 < 50)
                                and v2 < 0.2 and n2 > 10):
                            kf, kd = k_row.fre, k_row.db
                            index1 = _max_index(kd, n3)
                            if (index1 == 1 and 190 < kf[1] < 205
                                    and kd[1] - kd[0] > 8
                                    and kd[1] - kd[2] > 8):
                                f2 = kf[1]
                                fre2_arr[i] = f2
                            elif (index1 == 2 and 190 < kf[2] < 205
                                  and kd[2] - kd[1] > 8
                                  and kd[2] - kd[3] > 8):
                                f2 = kf[2]
                                fre2_arr[i] = f2
                    elif 240 < self._pre_fre4 < 255:  # 247-329
                        if v2 < 0.1 and n2 > 10:
                            kf, kd = k_row.fre, k_row.db
                            index1 = _max_index(kd, n3)
                            if 300 < kf[index1] < 360:
                                f2 = kf[index1]
                                fre2_arr[i] = f2

                    if 50 < f2 < 60 and v2 > 0.1:
                        self._in_flag -= 1
                    elif 40 < f2 < 50 and v2 > 0.1:
                        pass
                    elif 160 < f2 < 170 and v2 < 0.1 and cnt <= 3:
                        self._in_flag -= 1
                    elif 235 < f2 < 260 and v2 < 0.1 and cnt <= 4:
                        if ((75 < self._pre_fre4 < 90)
                                or (75 < self._pre_fre3 < 90)):
                            self._in_flag = 0
                    elif 430 < f2 < 450 and v2 < 0.1 and cnt <= 4:
                        if ((140 < self._pre_fre4 < 155)
                                or (140 < self._pre_fre3 < 155)):
                            self._in_flag = 0
                    elif 210 < f2 < 230 and v2 < 0.1 and cnt <= 6:
                        if ((105 < self._pre_fre4 < 115)
                                or (105 < self._pre_fre3 < 115)):
                            self._in_flag = 0
                    elif 240 < self._pre_fre4 < 255:  # 247
                        fa = min(self._pre_fre4, f2)
                        fb = max(self._pre_fre4, f2)
                        _, k1, k2 = queue_fre2(fa, fb)
                        if k1 == 1 and k2 == 2 and abs(fa * 2 - fb) < 4:
                            self._in_flag = 0
                    elif 320 < self._pre_fre4 < 345:  # 330
                        if (105 < f2 < 115 and n3
                                and 105 < k_row.fre[0] / 2 < 115
                                and k_row.h[0] < 12 and n2 <= 4):
                            self._in_flag = 0

                    sub_fre = 5.0 if f2 > 230 else 2.0
                    if self._in_flag == self._delay_length + 1:
                        fre_out, _index = _compare_fre(mf, n1, f2)
                        if fre_out:
                            if abs(f2 - mf[_index]) < sub_fre:
                                out[i] = f2
                                self._pre_fre = f2
                            else:
                                out[i] = 0.0
                                self._in_flag -= 1
                        else:
                            if n1 and f2:
                                if f2 > mf[0]:
                                    out[i] = f2
                                    self._pre_fre = f2
                                    self._anchor_fre = mf[0]
                            if not self._anchor_fre:
                                self._in_flag -= 1
                elif (0.09 < v2 < 0.16 and cnt >= 4 and light[i] > 0.98):
                    self._in_flag += 1
                    sub_fre = 2.0
                    if self._in_flag == self._delay_length + 1 and f2:
                        fre_out, _index = _compare_fre(mf, n1, f2)
                        if fre_out:
                            if abs(f2 - mf[_index]) < sub_fre:
                                out[i] = f2
                                self._pre_fre = f2
                            else:
                                out[i] = 0.0
                                self._in_flag -= 1
                        else:
                            if n1 and f2:
                                if f2 > mf[0]:
                                    out[i] = f2
                                    self._pre_fre = f2
                                    self._anchor_fre = mf[0]
                            if not self._anchor_fre:
                                self._in_flag -= 1
                elif (v2 < 0.4
                      and (cnt > 9 or (self._pre_count > 9
                                       and self._pre_count2 > 9))
                      and light[i] > 0.98):
                    self._in_flag += 1
                    self._delay_length = 2
                    sub_fre = 5.0 if f2 > 230 else 2.0
                    if self._in_flag == self._delay_length + 1:
                        if f2:
                            fre_out, _index = _compare_fre(mf, n1, f2)
                            if fre_out:
                                if abs(f2 - mf[_index]) < sub_fre:
                                    out[i] = f2
                                    self._pre_fre = f2
                                else:
                                    out[i] = 0.0
                            else:
                                if n1 and f2:
                                    if f2 > mf[0]:
                                        out[i] = f2
                                        self._pre_fre = f2
                                        self._anchor_fre = mf[0]
                            if out[i]:
                                self._delay_length = 1
                                self._in_flag = self._delay_length + 1
                            else:
                                self._in_flag -= 1
                        else:
                            self._in_flag -= 1
                else:
                    self._in_flag = 0
                    self._keep_flag = 0
                    self._anchor_fre = 0.0
                    self._delay_length = 1

            self._pre_db = db_i
            self._pre_value = v2
            self._pre_fre_arr = list(c_row.fre[:n2])
            self._pre_db_arr = list(c_row.db[:n2])
            self._pre_length = n2
            self._pre_spec = spec2[:, i].copy()
            self._left_flux = self._pre_flux
            self._pre_flux = float(flux_arr[i])
            self._pre_count2 = self._pre_count
            self._pre_count = cnt
            self._pre_fre4 = self._pre_fre3
            self._pre_fre3 = self._pre_fre2
            self._pre_fre2 = self._pre_fre

        self._flux_arr = flux_arr
        return out

    def get_data_arr(self):
        return self._flux_arr
