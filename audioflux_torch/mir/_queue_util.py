"""Frequency-ratio primitives of the _queue candidate engine (exact port).

Counterpart of ``audioflux_tpu/mir/_queue_util.py``: a verbatim copy, only
its import paths changed (``tests/test_torch_pitch_host.py`` holds the two
equal on a seeded fuzz).

Reference ``src/util/flux_util.c`` (util_calTone:193, util_calToneTimes:220,
util_calRangeTimes:276) and ``src/mir/_queue.c`` (__queue_fre2:306,
__queue_fre3:95).  These are the ratio tests every _queue strategy and the
tune-track heuristics are built on: "is f2 an integer multiple of f1 when
both are snapped to the midi grid (with nearest-neighbour tone fallback)",
and the 2- / 3-candidate harmonic-base solvers.

Host-side scalar code (the candidate sets are tiny per frame); fuzz-verified
against the C symbols, which the reference exports (tests/test_queue_util).

Annotation note: the C source carries terse per-branch trace tags in a
private shorthand (harmonic-slot signatures like ``1x23`` meaning
"harmonics 1,2,3 present with a gap", arrows to the fundamental the
rule resolves toward, e.g. a ~110 Hz open-string).  Those tags are the
C author's expression and are NOT carried here; the behavior itself is
locked down branch-for-branch by the ctypes fuzz rigs in
``tests/test_queue_util.py`` (thousands of randomized cases per
strategy vs the compiled reference), which are the ground truth for
this port.
"""

from __future__ import annotations

import math

__all__ = ["cal_tone", "cal_tone_times", "cal_range_times",
           "queue_fre2", "queue_fre3", "queue_direct", "queue_weak",
           "queue_fast", "queue_slide", "queue_standard", "trist_dispatch",
           "trist3_resolve", "queue_bear", "queue_count", "queue_multi",
           "queue_valid98", "queue_odd98", "queue_cut_valid"]

_EPS = 0.81


def _roundf(x: float) -> int:
    """C roundf: ties away from zero (Python round is banker's)."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def _div_round(a: float, b: float) -> int:
    """roundf(a/b) with the C's div-by-zero behavior mirrored: a/0 is
    +-inf (or NaN), whose int cast is INT_MIN on x86 (cvttss2si)."""
    if b == 0:
        return -2147483648
    return _roundf(a / b)


def _midi_fre(midi: int) -> float:
    # powf(2, (midi-69)/12)*440 in float32
    import numpy as np
    return float(np.float32(2.0 ** ((midi - 69) / 12.0) * 440.0))


def cal_tone(value: float):
    """-> (tone frequency of the nearest midi, the 2nd-nearest tone)."""
    if value <= 0:
        # C: log2f(0) = -inf -> powf underflows to 0 for both tones
        return 0.0, 0.0
    midi = _roundf(12 * math.log2(value / 440.0) + 69)
    cur = _midi_fre(midi)
    pre = _midi_fre(midi - 1)
    nxt = _midi_fre(midi + 1)
    sel = nxt if nxt - value < value - pre else pre
    return cur, sel


def cal_tone_times(value1: float, value2: float):
    """-> (k, type): k such that the tone of k*min == the other, else 0.
    type=1 when value1 > value2 (inverted ratio)."""
    if not value1 or not value2:
        return 0, 0
    t = 0
    if abs(value1 - value2) < _EPS:
        k = 1
    elif value2 - value1 > _EPS:
        k = _roundf(value2 / value1)
        tone, _ = cal_tone(k * value1)
        if not abs(value2 - tone) < _EPS:
            k = 0
    else:
        k = _roundf(value1 / value2)
        tone, _ = cal_tone(k * value2)
        if not abs(value1 - tone) < _EPS:
            k = 0
        t = 1
    return k, t


def cal_range_times(value1: float, value2: float):
    """util_calRangeTimes: tone-times with 2nd-nearest-tone fallbacks and a
    +-1 correction for large k.  -> (k, type)."""
    v1, s1 = cal_tone(value1)
    v2, s2 = cal_tone(value2)

    slack1 = 10.0 if value1 > 660 else (5.0 if value1 > 330 else 0.0)
    slack2 = 10.0 if value2 > 660 else (5.0 if value2 > 330 else 0.0)
    flag1 = abs(abs(v1 - value1) - abs(s1 - value1)) < slack1
    flag2 = abs(abs(v2 - value2) - abs(s2 - value2)) < slack2

    k, t = cal_tone_times(v1, v2)
    if not k and (value1 < 330 or flag1):
        k, t = cal_tone_times(s1, v2)
        if not k and (value2 < 330 or flag2):
            k, t = cal_tone_times(v1, s2)
            if not k:
                k, t = cal_tone_times(s1, s2)

    if k > 10:
        e1 = abs((k - 1) * value1 - value2)
        e2 = abs(k * value1 - value2)
        e3 = abs((k + 1) * value1 - value2)
        if e1 < e2 and e1 < e3:
            k -= 1
        elif e3 < e1 and e3 < e2:
            k += 1
    return k, t


def queue_fre2(value1: float, value2: float):
    """__queue_fre2: base frequency + harmonic numbers of two candidates.
    -> (fre, k1, k2); fre == 0 when no harmonic relation found."""
    fre, k1, k2 = 0.0, 0, 0
    k, _ = cal_range_times(value1, value2)
    if k:
        fre, k1, k2 = value1, 1, k
    else:
        sub = value2 - value1
        got = False
        _k2, _ = cal_range_times(sub, value2)
        if _k2:
            _k1, t = cal_range_times(sub, value1)
            if _k1 and not t:
                fre, k1, k2 = value1 / _k1, _k1, _k2
                got = True
        if not got:
            sub /= 2
            _k2, _ = cal_range_times(sub, value2)
            if _k2:
                _k1, t = cal_range_times(sub, value1)
                if _k1 and not t:
                    fre, k1, k2 = value1 / _k1, _k1, _k2
    if not fre:
        k1 = k2 = 0
    return fre, k1, k2


def queue_fre3(value1: float, value2: float, value3: float):
    """__queue_fre3: base frequency + spacings + harmonic numbers of three
    ascending candidates.  -> (base, s1, s2, k1, k2, k3)."""
    base = 0.0
    k1 = k2 = k3 = 0
    s1 = s2 = 0

    sub1 = value2 - value1
    sub2 = value3 - value2
    g_flag = 0
    if sub1 > sub2:
        sub1, sub2 = sub2, sub1
        g_flag = 1

    k, _ = cal_range_times(sub1, sub2)
    if k == 1:  # 1:1
        k1, _ = cal_range_times(sub1, value1)
        k2, _ = cal_range_times(sub1, value2)
        if k1 and k2:
            k3 = k2 + 1
            s1 = s2 = 1
            base = value1 / k1
        else:  # 2:2
            k1, _ = cal_range_times(sub1 / 2, value1)
            k2, _ = cal_range_times(sub1 / 2, value2)
            if k1 and k2:
                k3 = k2 + 2
                if k1 % 2 == 1:
                    s1 = s2 = 2
                    base = value1 / k1
                else:
                    s1 = s2 = 1
                    k1 //= 2
                    k2 //= 2
                    k3 //= 2
                    base = value1 / k1
    elif 2 <= k <= 4:  # 1:2 1:3 1:4
        k1, _ = cal_range_times(sub1, value1)
        k2, _ = cal_range_times(sub1, value2)
        if k1 and k2:
            k3 = k2 + (1 if g_flag else k)
            s1 = k if g_flag else 1
            s2 = 1 if g_flag else k
            base = value1 / k1
    else:  # 2:3
        sub = sub2 - sub1
        a, _ = cal_range_times(sub, sub1)
        b, _ = cal_range_times(sub, sub2)
        if a == 2 and b == 3:
            k1, _ = cal_range_times(sub1 / 2, value1)
            k2, _ = cal_range_times(sub1 / 2, value2)
            if k1 and k2:
                k3 = k2 + (2 if g_flag else 3)
                s1 = 3 if g_flag else 2
                s2 = 2 if g_flag else 3
                base = value1 / k1

    if not base:
        k = _div_round(sub2, sub1)
        if k == 1:
            k1 = _div_round(value1, sub1)
            k2 = _div_round(value2, sub1)
            # C divides unguarded: k1==0 yields inf and the <5 validity
            # check below then clears base (mirrored via math.inf)
            if k1 + 1 == k2:
                k3 = k2 + 1
                s1 = s2 = 1
                base = value1 / k1 if k1 else math.inf
            else:
                k1 = _div_round(value1, sub1 / 2)
                k2 = _div_round(value2, sub1 / 2)
                if k1 + 2 == k2:
                    k3 = k2 + 2
                    s1 = s2 = 2
                    base = value1 / k1 if k1 else math.inf
        elif 2 <= k <= 4:
            k1 = _div_round(value1, sub1)
            k2 = _div_round(value2, sub1)
            if k1 and k2:
                k3 = k2 + (1 if g_flag else k)
                s1 = k if g_flag else 1
                s2 = 1 if g_flag else k
                base = value1 / k1
        if base:
            h = value1 / k1 if k1 else math.inf
            if not (abs(value2 - h * k2) < 5
                    and abs(value3 - h * k3) < 5):
                base = 0.0

    if not base:
        s1 = s2 = k1 = k2 = k3 = 0
    return base, s1, s2, k1, k2, k3


# ---------------------------------------------------------------------------
# strategy helpers (_queue.c statics)

def _valid_fre3(fre1, fre2, fre3, base, k1, k2, k3):
    """__validFre3 (_queue.c:7583): harmonic numbers must predict fre2/fre3."""
    s1 = abs(base * k2 - fre2)
    s2 = abs(base * k3 - fre3)
    if (s1 > 5 and fre1 < 880) or s1 > 10:
        return 0
    if s2 > 10:
        return 0
    return 1


def _max_index(arr, length):
    """__arr_maxIndex: argmax with first-win ties (C strict <)."""
    index = 0
    value = arr[0]
    for i in range(1, length):
        if value < arr[i]:
            value = arr[i]
            index = i
    return index


def queue_direct(fre_arr, db_arr, height_arr, index_arr, length,
                 light=0.0, valid=0):
    """__queue_direct (_queue.c:5516): resolve obvious 1:2:3-style stacks.

    Inputs are per-frame candidate arrays (frequency-ascending with their
    dominance ranks in ``index_arr``); returns the fundamental or 0.
    """
    if valid:
        return 0.0
    fre = 0.0
    if length >= 3:
        _index = _max_index(db_arr, length)
        arr1 = sorted(db_arr[:3], reverse=True)
        if arr1[0] - arr1[2] < 12:
            i1, i2, i3 = index_arr[0], index_arr[1], index_arr[2]
            us = uk = (0, 0, 0)
            uk1 = uk2 = uk3 = 0
            if i1 + i2 + i3 == 3:
                fre, _, _, uk1, uk2, uk3 = queue_fre3(
                    fre_arr[0], fre_arr[1], fre_arr[2])
            if fre:
                q_flag = _valid_fre3(fre_arr[0], fre_arr[1], fre_arr[2],
                                     fre, uk1, uk2, uk3)
                if not q_flag:  # rejected by the ratio-format gate
                    fre = 0.0
                    if length >= 4:
                        _, _, _, uk1, uk2, uk3 = queue_fre3(
                            fre_arr[1], fre_arr[2], fre_arr[3])
                        if uk1 == 1:
                            fre = fre_arr[1]
                    if not fre and length >= 5:
                        _, _, _, uk1, uk2, uk3 = queue_fre3(
                            fre_arr[2], fre_arr[3], fre_arr[4])
                        if uk1 == 1:
                            fre = fre_arr[2]
                else:
                    if uk1 == 1 and uk2 == 3 and uk3 == 6:
                        if fre > 100:  # high-fre stack
                            if db_arr[0] < db_arr[1] < db_arr[2]:
                                fre = fre_arr[1]
                            elif length >= 4:
                                _, _, _, uk1, uk2, uk3 = queue_fre3(
                                    fre_arr[1], fre_arr[2], fre_arr[3])
                                if uk1 == 1:
                                    fre = fre_arr[1]
                    elif uk1 == 1 and uk2 == 2 and uk3 == 4:
                        if db_arr[1] > db_arr[2] > db_arr[0]:
                            return 0.0
                    elif 2 * uk1 == uk3:
                        return 0.0
                    elif 2 * uk2 == uk3:
                        fre = 0.0 if length > 5 else fre_arr[1]
                    elif (uk1 == 2 and uk2 == 4 and uk3 == 5
                          and _index == 2 and db_arr[0] < db_arr[1]
                          and 240 < fre_arr[2] < 250):
                        fre = 0.0
                    elif (uk1 == 7 and uk2 == 8 and uk3 == 12
                          and _index == 1
                          and 130 < fre_arr[1] / 2 < 160):
                        fre = fre_arr[1] / 2
                    else:
                        if uk1 != 1 and length >= 4:
                            _, _, _, uk1, uk2, uk3 = queue_fre3(
                                fre_arr[1], fre_arr[2], fre_arr[3])
                            if uk1 == 1:
                                fre = fre_arr[1]

    if not fre and length >= 3:
        if index_arr[0] + index_arr[1] + index_arr[2] == 3:
            _, _, _, uk1, uk2, uk3 = queue_fre3(
                fre_arr[0], fre_arr[1], fre_arr[2])
            if uk1 == 1 and uk2 == 2 and uk3 == 4:
                if db_arr[1] > db_arr[2] > db_arr[0]:
                    return 0.0
            elif uk1 and 2 * uk1 == uk3:
                return 0.0
    return fre


def _queue_weak_valid(fre_arr, db_arr, height_arr, index_arr, length):
    """__queue_weakValid (_queue.c:6774)."""
    index = _max_index(db_arr, length)
    if index == 1 and fre_arr[index] - fre_arr[index - 1] < 50:
        for i in range(index + 1, length):
            _fre, k1, k2 = queue_fre2(fre_arr[index], fre_arr[i])
            if k1 == 1:
                return _fre
    return 0.0


def queue_weak(fre_arr, db_arr, height_arr, index_arr, length,
               light=0.0, valid=0):
    """__queue_weak (_queue.c:6618): low-evidence frames (<=3 candidates)."""
    if length < 2:
        return 0.0
    fre = _queue_weak_valid(fre_arr, db_arr, height_arr, index_arr, length)
    if fre:
        return fre
    k1 = k2 = k3 = k4 = 0
    if length == 2:
        fre, k1, k2 = queue_fre2(fre_arr[0], fre_arr[1])
        if k1 == 2 and k2 == 3:
            if abs(db_arr[0] - db_arr[1]) > 8:
                fre = 0.0
        elif k1 == 1:
            if db_arr[0] < db_arr[1]:
                fre = 0.0
        else:
            fre = fre_arr[0] if db_arr[0] > db_arr[1] else fre_arr[1]
    elif length == 3:
        fre1, k1, k2 = queue_fre2(fre_arr[0], fre_arr[1])
        fre2, k3, k4 = queue_fre2(fre_arr[1], fre_arr[2])
        if k1:
            if k1 == 2 and k2 == 3:
                fre = fre1
                if db_arr[0] - db_arr[1] > 20 and fre_arr[0] > 220:
                    fre = fre_arr[0]
                if height_arr[0] < 5:
                    fre = fre_arr[1] if db_arr[1] - db_arr[0] > 10 else 0.0
            elif k1 == 1:
                if k2 == 2:
                    fre = fre2
                    if fre1 < 90 or db_arr[0] > db_arr[1]:
                        fre = fre1
                    elif fre1 > 300 and db_arr[1] - db_arr[0] < 2:
                        fre = fre1
                else:
                    fre = fre2 if db_arr[1] - db_arr[0] > 8 else fre1
        else:  # first candidate is noise
            if _max_index(db_arr, length) == 0:
                fre = fre_arr[0]
        if not fre:
            if (db_arr[0] - db_arr[1] > 20 and db_arr[1] > db_arr[2]
                    and fre_arr[0] > 220):
                return fre_arr[0]
        if not fre:
            if k3 == 1 and k4 < 4:
                fre = fre2
        if not fre:
            fre = fre_arr[_max_index(db_arr, length)]
    else:
        for i in range(length - 1):
            if index_arr[i] + index_arr[i + 1] == 1:
                if abs(db_arr[i] - db_arr[i + 1]) < 15:
                    fre = 0.0
                    break
    if fre:
        _index = _max_index(db_arr, length)
        if 40 < fre < 50 and fre_arr[_index] / fre > 5.5:
            fre = fre_arr[_index]
        elif fre < 40 and fre_arr[_index] / fre > 7:
            fre = fre_arr[_index]
    return fre


def queue_fast(fre_arr, db_arr, height_arr, index_arr, length,
               fre_arr2=(), db_arr2=(), height_arr2=(), ref_length=0,
               light=0.0, valid=0):
    """__queue_fast (_queue.c:5113): strict 1:1-spacing stack resolution.

    ``fre_arr2``/``ref_length`` are the frame's wider (pre-cut) candidate
    set, consulted by the 1:2:6 validation branch.
    """
    def g2(arr, i):
        return arr[i] if i < len(arr) else 0.0

    if valid and ref_length > 5:
        return 0.0
    fre = 0.0

    if length >= 3:
        for i in range(length - 2):
            if index_arr[i] + index_arr[i + 1] + index_arr[i + 2] == 3:
                _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    fre_arr[i], fre_arr[i + 1], fre_arr[i + 2])
                if us1 == 1 and us1 == us2:
                    if (abs(_fre * uk2 - fre_arr[i + 1]) < 5
                            and abs(_fre * uk3 - fre_arr[i + 2]) < 5):
                        fre = _fre
                        if index_arr[i] == 0 and 2 * uk1 == uk3:
                            return 0.0
                break
        if not fre:
            for i in range(length - 2):
                if index_arr[i] + index_arr[i + 1] == 1:
                    _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                        fre_arr[i], fre_arr[i + 1], fre_arr[i + 2])
                    if us1 == 1 and us1 == us2:
                        if (abs(_fre * uk2 - fre_arr[i + 1]) < 5
                                and abs(_fre * uk3 - fre_arr[i + 2]) < 5):
                            fre = _fre
                            if (index_arr[i] == 0 and 2 * uk1 == uk3
                                    and ref_length > 5):
                                return 0.0
                    break
        if not fre:
            for i in range(length - 2):
                if (index_arr[i] + index_arr[i + 1] == 2
                        and index_arr[i + 2] == 3):
                    _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                        fre_arr[i], fre_arr[i + 1], fre_arr[i + 2])
                    if us1 == 1 and us1 == us2:
                        if (abs(_fre * uk2 - fre_arr[i + 1]) < 5
                                and abs(_fre * uk3 - fre_arr[i + 2]) < 5):
                            fre = _fre
                            if index_arr[i] == 0 and 2 * uk1 == uk3:
                                return 0.0
                    break
        if not fre and index_arr[0] == 0:
            _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                fre_arr[0], fre_arr[1], fre_arr[2])
            if us1 == 1 and us1 == us2:
                if (abs(_fre * uk2 - fre_arr[1]) < 5
                        and abs(_fre * uk3 - fre_arr[2]) < 5):
                    fre = _fre
                    if 2 * uk1 == uk3:
                        return 0.0

# 2. overtone-stack sweeps around the dB-max candidate
    if not fre and length >= 4:
        _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
            fre_arr[0], fre_arr[1], fre_arr[2])
        if uk1:
            _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(
                fre_arr[1], fre_arr[2], fre_arr[3])
            if vk1:
                if (uk1 == 1 and uk2 == 2 and uk3 == 4
                        and ((vk1 == 2 and vk2 == 4 and vk3 == 5)
                             or (vk1 == 2 and vk2 == 4 and vk3 == 7))):
                    fre = _fre
                elif (uk1 == 2 and uk2 == 3 and uk3 == 4
                      and vk1 == 3 and vk2 == 4 and vk3 == 7):
                    fre = fre_arr[0] / 2
            else:
                if length >= 5 and uk1 == 1 and uk2 == 2 and uk3 == 4:
                    _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(
                        fre_arr[2], fre_arr[3], fre_arr[4])
                    if vk1 == 4 and vk2 == 8 and vk3 == 11:
                        fre = fre_arr[0] / 2
            if (not fre and uk1 == 1 and uk2 == 2 and uk3 == 4
                    and db_arr[2] > db_arr[0] and db_arr[2] > db_arr[1]
                    and db_arr[0] > db_arr[1]
                    and 380 < fre_arr[2] < 405):
                fre = fre_arr[2] / 2

    # 3. 1:n around the dB-max candidate
    if not fre:
        index1 = _max_index(db_arr, length)
        if index1 == 1 and fre_arr[0] < 85 and ref_length < 5:
            _fre, uk1, uk2 = queue_fre2(fre_arr[0], fre_arr[1])
            if (uk1 == 1 and uk2 == 2
                    and abs(fre_arr[0] * 2 - fre_arr[1]) < 5):
                return _fre
        if index1 + 1 < length:
            _fre2 = fre_arr[index1 + 1]
            _fre, uk1, uk2 = queue_fre2(fre_arr[index1], fre_arr[index1 + 1])
            if not uk1 and index1 + 2 < length:
                _fre2 = fre_arr[index1 + 2]
                if 210 < _fre2 < 230:
                    _fre, uk1, uk2 = queue_fre2(fre_arr[index1],
                                                fre_arr[index1 + 2])
            if uk1 == 1 and uk2 in (2, 3):
                if abs(_fre * uk2 - _fre2) < 5:
                    fre = _fre
                    if (db_arr[index1] - db_arr[index1 + 1] > 18
                            and fre_arr[index1] > 130):
                        return fre
                    if fre > 330 and index1 + 2 < length:
                        _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                            fre_arr[index1], fre_arr[index1 + 1],
                            fre_arr[index1 + 2])
                        if us1:
                            if (abs(fre_arr[index1] / uk1 * uk2
                                    - fre_arr[index1 + 1]) < 5
                                    and abs(fre_arr[index1] / uk1 * uk3
                                            - fre_arr[index1 + 2]) < 5):
                                fre = _fre
        if not index1:
            # validate against 1:2:4 / 1:3:6 overtone traps
            if fre and index1 + 2 < length:
                _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    fre_arr[index1], fre_arr[index1 + 1],
                    fre_arr[index1 + 2])
                if uk1 == 1 and ((uk2 == 2 and uk3 == 4)
                                 or (uk2 == 3 and uk3 == 6)):
                    fre = 0.0
                elif (uk1 == 1 and uk2 == 2 and uk3 == 6
                      and 190 < fre_arr[1] < 204):
                    fre = 0.0
                else:
                    if us1 and us1 == 2 * us2:
                        if (abs(fre_arr[index1] / uk1 * uk2
                                - fre_arr[index1 + 1]) < 5
                                and abs(fre_arr[index1] / uk1 * uk3
                                        - fre_arr[index1 + 2]) < 5):
                            fre = _fre
        else:
            if fre and index1 == 1:
                _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    g2(fre_arr, 0), g2(fre_arr, 1), g2(fre_arr, 2))
                if uk1 == 1 and uk2 == 2 and uk3 == 6 and _fre < 90:
                    if db_arr[1] > db_arr[0] and db_arr[1] - db_arr[2] > 20:
                        if ref_length < 6:
                            return _fre
                        elif ref_length < 8:
                            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                                g2(fre_arr2, 0), g2(fre_arr2, 1),
                                g2(fre_arr2, 2))
                            if uk1 == 1 and uk2 == 2 and uk3 == 6:
                                _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                                    g2(fre_arr2, 1), g2(fre_arr2, 2),
                                    g2(fre_arr2, 3))
                                if uk1 == 2 and uk2 == 6 and uk3 == 7:
                                    return _fre
                                if (g2(fre_arr2, 1) + g2(fre_arr2, 2)
                                        < g2(fre_arr2, 3)):
                                    _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                                        g2(fre_arr2, 1) + g2(fre_arr2, 2),
                                        g2(fre_arr2, 3), g2(fre_arr2, 4))
                                    if uk1 == 8 and uk2 == 11 and uk3 == 12:
                                        return _fre
                _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    g2(fre_arr, 1), g2(fre_arr, 2), g2(fre_arr, 3))
                if (uk1 == 1 and ((uk2 == 2 and uk3 == 4)
                                  or (uk2 == 2 and uk3 == 6))
                        and 190 < fre_arr[2] < 204):
                    fre = 0.0
            if fre and ref_length > 5:
                for i in range(index1):
                    _fre, uk1, uk2 = queue_fre2(fre_arr[i], fre_arr[index1])
                    if uk1 == 1 and uk2 in (2, 3):
                        _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                            fre_arr[i], fre_arr[index1],
                            g2(fre_arr, index1 + 1))
                        if (abs(_fre * uk2 - fre_arr[index1]) < 5
                                and abs(_fre * uk3
                                        - g2(fre_arr, index1 + 1)) < 5):
                            fre = 0.0
                        if not fre and index1 + 2 < length:
                            _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                                fre_arr[index1], fre_arr[index1 + 1],
                                fre_arr[index1 + 2])
                            if us1 and us1 == 3 * us2:
                                if (abs(fre_arr[i] * uk2
                                        - fre_arr[index1 + 1]) < 5
                                        and abs(fre_arr[i] * uk3
                                                - fre_arr[index1 + 2]) < 5):
                                    fre = _fre
                        break

    if not fre:
        index1 = _max_index(db_arr, length)
        if not index1 and 190 < fre_arr[index1] < 204:
            # the C reads dbArr[1] even at length 1 (calloc'd zero past
            # the logical end, _queue.c:5503)
            if db_arr[0] - g2(db_arr, 1) > 18:
                return fre_arr[0]
    return fre


# ---------------------------------------------------------------------------
# __queue_slide machinery (_queue.c:5673-7331)

def _g(arr, i):
    """C reads its calloc'd peak arrays past lenArr: zeros beyond length."""
    return arr[i] if 0 <= i < len(arr) else 0.0


def queue_query2(fre_arr, db_arr, height_arr, length, start, value1, value2,
                 strict):
    """__queue_query2 (_queue.c:1004): odd-harmonic presence probe."""
    count = 0
    for i in range(start, length):
        k1, t = cal_range_times(value1, _g(fre_arr, i))
        if k1 and not t:
            hit = False
            if k1 in (3, 5, 7, 9, 11, 13):
                if k1 <= 5 and abs(value1 * k1 - _g(fre_arr, i)) < 6:
                    hit = True
                elif k1 <= 9 and abs(value1 * k1 - _g(fre_arr, i)) < 12:
                    hit = True
                elif k1 == 11 and abs(value1 * k1 - _g(fre_arr, i)) < 18:
                    hit = True
                elif k1 == 13 and abs(value1 * k1 - _g(fre_arr, i)) < 20:
                    hit = True
            if hit:
                if strict:
                    if i == start and i < length - 1:
                        if _g(db_arr, i + 1) - _g(db_arr, i) < 8:
                            count += 1
                    elif i == length - 1 and i > 0:
                        if _g(db_arr, i - 1) - _g(db_arr, i) < 8:
                            count += 1
                    elif 0 < i < length - 1:
                        if (_g(db_arr, i - 1) - _g(db_arr, i) < 8
                                or _g(db_arr, i + 1) - _g(db_arr, i) < 8):
                            count += 1
                else:
                    count += 1
            if strict < 2 and count:
                return 1
            if strict >= 2 and count >= strict:
                return 1
    return 0


def queue_query3(fre_arr, db_arr, height_arr, length, start, value1, value2,
                 strict):
    """__queue_query3 (_queue.c:1128): non-{1,2,3,6}-harmonic probe."""
    for i in range(start, length):
        k1, t = cal_range_times(value1, _g(fre_arr, i))
        if k1 and not t:
            flag = 0
            if k1 in (4, 5, 7, 8, 10, 11, 13):
                f = _g(fre_arr, i)
                if k1 <= 5 and abs(value1 * k1 - f) < 6:
                    flag = 1
                elif k1 <= 9 and abs(value1 * k1 - f) < 12:
                    flag = 1
                elif k1 <= 11 and abs(value1 * k1 - f) < 18:
                    flag = 1
                    k2, _ = cal_range_times(value2, f)
                    if k1 == 10 and k2 == 3 and abs(value2 * k2 - f) < 8:
                        flag = 0
                elif k1 == 13 and abs(value1 * k1 - f) < 20:
                    flag = 1
                    k2, _ = cal_range_times(value2, f)
                    if k2 == 4 and abs(value2 * k2 - f) < 10:
                        flag = 0
            if flag:
                return 1
    return 0


def queue_is_equal(fre_arr, length, index1, k1, index2, k2):
    """__queue_isEqual (_queue.c:7292): same fundamental across two anchors."""
    if not k1 or not k2:
        return 0
    if index1 == index2:
        return 1 if k1 == k2 else 0
    if index1 > index2:
        index1, k1, index2, k2 = index2, k2, index1, k1
    _k, _ = cal_range_times(_g(fre_arr, index1) / k1, _g(fre_arr, index2))
    return 1 if _k == k2 else 0


def queue_has(fre_arr, length, base_fre, start):
    """__queue_has (_queue.c:7444). -> (flag, index)."""
    for i in range(start, length - 2):
        fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
            _g(fre_arr, i), _g(fre_arr, i + 1), _g(fre_arr, i + 2))
        if fre:
            k1, _ = cal_range_times(fre, base_fre)
            if k1 == 1:
                return 1, i
    return 0, 0


def queue_cal(fre_arr, db_arr, height_arr, length, start, flag):
    """__queue_cal (_queue.c:7335).
    -> (len, index1, k1, index2, k2, jump_flag)."""
    index1 = k1 = index2 = k2 = jump_flag = 0
    if start + 2 >= length:
        return 0, index1, k1, index2, k2, jump_flag
    base, us1, us2, uk1, uk2, uk3 = queue_fre3(
        _g(fre_arr, start), _g(fre_arr, start + 1), _g(fre_arr, start + 2))
    if flag and base:
        q_flag = _valid_fre3(_g(fre_arr, start), _g(fre_arr, start + 1),
                             _g(fre_arr, start + 2), base, uk1, uk2, uk3)
        if not q_flag:
            us1 = us2 = uk1 = uk2 = uk3 = 0
            if (_g(db_arr, start + 2) > _g(db_arr, start + 1)
                    and _g(db_arr, start + 2) > _g(db_arr, start)):
                return 0, index1, k1, index2, k2, jump_flag
    ln = 0
    if us1:
        ln = 1
        if (uk1 * 2 == uk3) or (uk1 * 2 == uk2 and uk1 != 1):
            jump_flag = 1 if uk1 * 2 == uk3 else 2
            index2, k2 = start, 1
            ln = 2
        elif uk1 == 4 and uk3 == 6:
            jump_flag = 1
            index2, k2 = start, 2
            ln = 2
        index1, k1 = start, uk1
    else:
        if start + 3 < length:
            _, uk1, uk2 = queue_fre2(_g(fre_arr, start), _g(fre_arr, start + 1))
            if uk1 and uk1 * 2 == uk2:
                _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    _g(fre_arr, start), _g(fre_arr, start + 1),
                    _g(fre_arr, start + 3))
                if us1:
                    index1, k1 = start, uk1
                    jump_flag = 2
                    ln = 1
            else:
                _, uk1, uk3 = queue_fre2(_g(fre_arr, start),
                                         _g(fre_arr, start + 2))
                if uk1 and uk1 * 2 == uk3:
                    _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                        _g(fre_arr, start), _g(fre_arr, start + 2),
                        _g(fre_arr, start + 3))
                    if us1:
                        index1, k1 = start, uk1
                        jump_flag = 1
                        ln = 1
    return ln, index1, k1, index2, k2, jump_flag


def queue_jump_bound(fre_arr, db_arr, height_arr, length, start,
                     index1, k1, jump_flag):
    """__queue_jumpBound (_queue.c:7164). -> (fre, index2, k2, offset)."""
    fre = 0.0
    index2 = k2 = 0
    offset = length - 1
    if start + 4 < length:
        if jump_flag == 1:
            _fre1 = _g(fre_arr, start + 2)
            _index3 = start + 2
        else:
            _fre1 = _g(fre_arr, start + 1)
            _index3 = start + 1
        _, us1, us2, uka, _ukb, _ukc = queue_fre3(
            _fre1, _g(fre_arr, start + 3), _g(fre_arr, start + 4))
        _uk3 = uka
        f1 = queue_is_equal(fre_arr, length, index1, k1, _index3, uka)
        _, us1, us2, uk1_, uk2_, uk3_ = queue_fre3(
            _g(fre_arr, start + 1), _g(fre_arr, start + 2),
            _g(fre_arr, start + 3))
        _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(
            _g(fre_arr, start + 2), _g(fre_arr, start + 3),
            _g(fre_arr, start + 4))
        f2 = queue_is_equal(fre_arr, length, start + 1, uk1_, start + 2, uk2_)
        if f1:
            if f2:
                index2, k2 = start + 1, uk1_
                offset = start + 3
            else:
                fre = _g(fre_arr, index1) / k1
                if uk1_:
                    index2, k2 = start + 1, uk1_
                elif vk1 and jump_flag == 2:
                    index2, k2 = start + 2, vk1
                offset = start + 3
        else:
            if f2:
                fre = _g(fre_arr, start + 1) / uk1_
                index2, k2 = start + 1, uk1_
                offset = start + 3
            else:
                if _uk3 or uk1_ or vk1:
                    if _uk3:
                        index2, k2 = _index3, _uk3
                    elif uk1_:
                        index2, k2 = start + 1, uk1_
                    else:
                        index2, k2 = start + 2, vk1
                    offset = index2 + 1
                else:
                    offset = start + 3
    else:
        _, us1, us2, uk1_, uk2_, uk3_ = queue_fre3(
            _g(fre_arr, start + 1), _g(fre_arr, start + 2),
            _g(fre_arr, start + 3))
        if us1:
            index2, k2 = start + 1, uk1_
    return fre, index2, k2, offset


def queue_two_move(fre_arr, db_arr, height_arr, length, start,
                   index1, k1, index2, k2, jump_flag):
    """__queue_twoMove (_queue.c:6806). -> (fre, offset)."""
    fre = 0.0
    _index = _max_index(db_arr, length)
    _, us1, us2, uk1, uk2, uk3 = queue_fre3(
        _g(fre_arr, start), _g(fre_arr, start + 1), _g(fre_arr, start + 2))
    if (_index == start and uk1 == 2 and uk2 == 3 and uk3 == 4
            and 130 < _g(fre_arr, start) / 2 < 160):
        return _g(fre_arr, start) / 2, length - 1
    elif (_index == start and uk1 == 2 and uk2 == 3 and uk3 in (4, 6)
          and 220 < _g(fre_arr, start) / 2 < 300):
        return _g(fre_arr, start) / 2, length - 1
    elif uk1 == 2 and uk2 == 3 and 150 < _g(fre_arr, start) < 180:
        if _g(db_arr, start + 1) > _g(db_arr, start + 2):
            flag = 1
        else:
            flag = queue_query2(fre_arr[start:], db_arr[start:],
                                height_arr[start:], length - start, 0,
                                _g(fre_arr, start) / 2, _g(fre_arr, start), 1)
        if flag:
            return _g(fre_arr, start) / 2, length - 1

    offset = length - 1
    i = start + 1
    while i < length - 2:
        if i in (start + 1, start + 2, start + 3):
            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(fre_arr, i), _g(fre_arr, i + 1), _g(fre_arr, i + 2))
            if (i == start + 2 and jump_flag == 1) or i == start + 3:
                f1 = queue_is_equal(fre_arr, length, index1, k1, i, uk1)
                if f1:
                    fre = _g(fre_arr, index1) / k1
                    break
                f2 = queue_is_equal(fre_arr, length, index2, k2, i, uk1)
                if not f2:
                    if (_g(fre_arr, i) > 440
                            or _g(db_arr, i) < _g(db_arr, index2)):
                        f2 = queue_is_equal(fre_arr, length, index2, k2,
                                            i, 2 * uk1)
                if f2:
                    fre = _g(fre_arr, index2) / k2
                    break
                offset = i + 1
                break
            else:  # jump
                if i == start + 1:
                    _fre1 = _g(fre_arr, i - 1)
                    _fre2 = (_g(fre_arr, i + 1) if jump_flag == 1
                             else _g(fre_arr, i))
                    _fre3 = _g(fre_arr, i + 2)
                else:
                    _fre1 = _g(fre_arr, i - 1)
                    _fre2 = _g(fre_arr, i + 1)
                    _fre3 = _g(fre_arr, i + 2)
                _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(_fre1, _fre2, _fre3)
                f1 = queue_is_equal(fre_arr, length, index1, k1, i, uk1)
                f2 = queue_is_equal(fre_arr, length, index2, k2, i - 1, vk1)
                if not f2:
                    if (_g(fre_arr, i - 1) > 440
                            or _g(db_arr, i - 1) < _g(db_arr, index2)):
                        f2 = queue_is_equal(fre_arr, length, index2, k2,
                                            i - 1, 2 * vk1)
                if f1 or f2:
                    if not (f1 and f2):
                        if f1 and not f2:
                            fre = _g(fre_arr, index1) / k1
                            break
                        else:  # f2 and not f1
                            if vk1 == 1 and vk2 == 2 and vk3 in (4, 6):
                                _v_flag = 0
                                _index1 = 0
                                if i + 3 < length:
                                    _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(
                                        _fre2, _fre3, _g(fre_arr, i + 3))
                                    if vk1 == 1 and vk2 in (2, 3):
                                        _v_flag, _index1 = queue_has(
                                            fre_arr, length, _fre2, i + 2)
                                if _v_flag:
                                    fre = _fre2
                                    if index1 == 0:
                                        _imax = _max_index(db_arr, length)
                                        if _imax == 0 and k2 == 1 and vk1 == 1:
                                            _k, _ = cal_range_times(
                                                _g(fre_arr, index1), _fre2)
                                            if _k in (2, 4):
                                                fre = _g(fre_arr, index1)
                                    break
                            else:
                                fre = _g(fre_arr, index2) / k2
                                if vs2 == 4:
                                    _base = _g(fre_arr, index1) / k1
                                    _v_flag, _index1 = queue_has(
                                        fre_arr, length, _base, i + 2)
                                    if _v_flag:
                                        fre = _base
                                break
                else:  # fail
                    offset = i + 1
                    break
        i += 1
    return fre, offset


def queue_one_move(fre_arr, db_arr, height_arr, length, start, index1, k1):
    """__queue_oneMove (_queue.c:7007). -> (fre, index2, k2, offset)."""
    fre = 0.0
    index2 = k2 = 0
    offset = 0
    _index = _max_index(db_arr, length)
    _, us1, us2, uk1, uk2, uk3 = queue_fre3(
        _g(fre_arr, start), _g(fre_arr, start + 1), _g(fre_arr, start + 2))
    if (_index == start and uk1 == 2 and uk2 == 3 and uk3 in (4, 6)
            and _g(db_arr, start + 1) > _g(db_arr, start + 2)
            and 220 < _g(fre_arr, start) / 2 < 300):
        return _g(fre_arr, start) / 2, index2, k2, length - 1
    for i in range(start + 1, length - 2):
        _len, _index1, _k1, _index2, _k2, _jump_flag = queue_cal(
            fre_arr, db_arr, height_arr, length, i, 0)
        offset = length - 1
        if _len:
            if _len == 2:
                if queue_is_equal(fre_arr, length, index1, k1, _index1, _k1):
                    fre = _g(fre_arr, index1) / k1
                    break
                index2, k2 = _index1, _k1
                offset = i + 1
                break
            else:
                if not _jump_flag:  # one
                    if queue_is_equal(fre_arr, length, index1, k1,
                                      _index1, _k1):
                        fre = _g(fre_arr, index1) / k1
                        break
                    index2, k2 = _index1, _k1
                    offset = i + 1
                    break
                else:  # jump
                    fre, _index2, _k2, offset = queue_jump_bound(
                        fre_arr, db_arr, height_arr, length, i,
                        _index1, _k1, _jump_flag)
                    if not fre:
                        if queue_is_equal(fre_arr, length, index1, k1,
                                          _index1, _k1):
                            fre = _g(fre_arr, index1) / k1
                            break
                        if _k2:
                            if queue_is_equal(fre_arr, length, index1, k1,
                                              _index2, _k2):
                                fre = _g(fre_arr, index1) / k1
                                break
                        index2, k2 = _index1, _k1
                        offset = _index1 + 1
                        break
    return fre, index2, k2, offset


def queue_jump_move(fre_arr, db_arr, height_arr, length, start,
                    index1, k1, jump_flag):
    """__queue_jumpMove (_queue.c:7129). -> (fre, index2, k2, offset)."""
    fre, index2, k2, offset = queue_jump_bound(
        fre_arr, db_arr, height_arr, length, start, index1, k1, jump_flag)
    if not fre and not k2:
        fre, index2, k2, offset = queue_one_move(
            fre_arr, db_arr, height_arr, length, start, index1, k1)
    return fre, index2, k2, offset


def _slide_valid(fre_arr, db_arr, height_arr, index_arr, length, value):
    """__queue_slideValid (_queue.c:6292): re-anchor on the dB-max peak."""
    fre = value
    fre1 = fre
    flag = 0
    # dB-desc views
    order = sorted(range(length), key=lambda j: -db_arr[j])
    s_fre = [fre_arr[j] for j in order]
    s_db = [db_arr[j] for j in order]
    _index1 = _max_index(db_arr, length)

    if fre > fre_arr[_index1] and fre - fre_arr[_index1] > 10:
        if _index1 == 0:
            for i in range(1, length):
                if s_fre[i] > fre - 10:
                    _, k1, k2 = queue_fre2(fre, s_fre[i])
                    if k1:
                        if db_arr[_index1] - s_db[i] > 10:
                            flag = 1
                            fre = fre_arr[_index1]
                    break
            if not flag and s_db[0] - s_db[1] > 24:
                flag = 1
                fre = fre_arr[_index1]
        else:
            for i in range(1, length):
                if s_fre[i] > fre_arr[_index1] - 10:
                    _, k1, k2 = queue_fre2(fre_arr[_index1], s_fre[i])
                    if k1 == 1:
                        if db_arr[_index1] - s_db[i] > 10:
                            flag = 1
                            fre = fre_arr[_index1]
                        else:
                            if (s_fre[i] > fre + 10
                                    and 190 < fre_arr[_index1] < 204
                                    and db_arr[_index1] - s_db[i] > 6):
                                flag = 1
                                fre = fre_arr[_index1]
                    elif (k1 == 2 and k2 == 3
                          and abs(fre_arr[_index1] / 2 * 3 - s_fre[i]) < 5
                          and db_arr[_index1] - s_db[i] > 10):
                        flag = 1
                        fre = fre_arr[_index1]
                    break
        if not flag:
            for i in range(length - 1):
                if abs(fre - fre_arr[i]) < 10:
                    _, k1, k2 = queue_fre2(fre_arr[_index1], fre_arr[i])
                    if k1 == 1 and k2 in (2, 3):
                        if fre_arr[_index1] > 130:
                            if (155 < fre_arr[_index1] < 175
                                    and k2 == 2):
                                pass
                            else:
                                fre = fre_arr[_index1]
                        else:
                            if k2 == 2:
                                f = queue_query2(fre_arr, db_arr, height_arr,
                                                 length, 0,
                                                 fre_arr[_index1], fre1, 0)
                            else:
                                f = queue_query3(fre_arr, db_arr, height_arr,
                                                 length, 0,
                                                 fre_arr[_index1], fre1, 0)
                            if f:
                                fre = fre_arr[_index1]
                    elif k1 == 2 and k2 == 3:
                        if (150 < fre_arr[_index1] < 180
                                or 380 < fre_arr[_index1] < 408):
                            fre = fre_arr[_index1] / 2
                    break
        if flag and _index1 == 0 and 100 < fre_arr[0] < 120:
            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(fre_arr, 0), _g(fre_arr, 1), _g(fre_arr, 2))
            if uk1 == 1 and uk2 == 2 and uk3 == 3:
                pass
            else:
                f = queue_query3(fre_arr, db_arr, height_arr, length, 0,
                                 fre_arr[_index1], fre1, 0)
                if not f:
                    fre = value
        if not flag and _index1 in (0, 1) and 100 < fre_arr[0] < 120:
            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(fre_arr, 0), _g(fre_arr, 1), _g(fre_arr, 2))
            if (uk1 == 1 and uk2 == 2 and uk3 == 3
                    and abs(fre_arr[0] * 2 - _g(fre_arr, 1)) < 5
                    and abs(fre_arr[0] * 3 - _g(fre_arr, 2)) < 5):
                flag = 1
                fre = fre_arr[0]
            else:
                _, k1, k2 = queue_fre2(_g(fre_arr, 0), _g(fre_arr, 1))
                if (k1 == 1 and k2 == 2
                        and _g(db_arr, 1) - _g(db_arr, 2) > 18):
                    if length > 6:  # valid {100,200}
                        f = queue_query2(fre_arr, db_arr, height_arr, length,
                                         0, _g(fre_arr, 0), _g(fre_arr, 1), 0)
                    else:
                        f = 1
                    if f:
                        flag = 1
                        fre = _g(fre_arr, 1) / 2
                elif length > 5:  # valid {220,330}
                    _, k1, k2 = queue_fre2(_g(fre_arr, 1), _g(fre_arr, 2))
                    if (k1 == 2 and k2 == 3
                            and _g(db_arr, 0) > _g(db_arr, 2)
                            and _g(db_arr, 1) > _g(db_arr, 2)
                            and _g(db_arr, 2) - _g(db_arr, 3) > 20
                            and abs(_g(fre_arr, 1) / 2 * 3
                                    - _g(fre_arr, 2)) < 4
                            and abs(_g(fre_arr, 0)
                                    - _g(fre_arr, 1) / 2) < 4):
                        flag = 1
                        fre = _g(fre_arr, 1) / 2

    if (not flag and _index1 == 0 and fre > fre_arr[_index1]
            and fre - fre_arr[_index1] > 10 and fre_arr[_index1] > 220):
        for i in range(length):
            if (abs(fre - fre_arr[i]) < 10
                    and db_arr[0] - db_arr[i] > 18):
                _, k1, k2 = queue_fre2(fre_arr[0], fre_arr[i])
                if k1 == 1:
                    flag = 1
                    fre = fre_arr[0]
                break

    if not flag:
        for i in range(length - 1):
            if (index_arr[i] + index_arr[i + 1] in (1, 2, 3)
                    and (abs(fre - fre_arr[i]) < 10
                         or abs(fre - fre_arr[i + 1]) < 10)):
                _, k1, k2 = queue_fre2(fre_arr[i], fre_arr[i + 1])
                if k1 == 1 and k2 in (2, 3):
                    if fre_arr[i] > 130:
                        if 155 < fre_arr[i] < 175 and k2 == 2:
                            pass
                        else:
                            fre = fre_arr[i]
                        break
                    elif index_arr[i] == 0:
                        if k2 == 2:
                            f = queue_query2(fre_arr, db_arr, height_arr,
                                             length, 0, fre_arr[i],
                                             fre_arr[i + 1], 0)
                        else:
                            f = queue_query3(fre_arr, db_arr, height_arr,
                                             length, 0, fre_arr[i],
                                             fre_arr[i + 1], 0)
                        if f:
                            if abs(fre - fre_arr[i]) > 10:
                                fre = fre_arr[i]
                        break
                elif k1 == 2 and k2 == 3:
                    if (index_arr[i] == 0
                            and (150 < fre_arr[i] < 180
                                 or 380 < fre_arr[i] < 408)):
                        fre = fre_arr[i] / 2
                        break
    return fre


def queue_slide(fre_arr, db_arr, height_arr, index_arr, length,
                light=0.0, valid=0):
    """__queue_slide (_queue.c:5673): sliding harmonic-stack tracker for low
    and middle frequencies.  Returns (fre, status)."""
    status = 0
    if not length:
        return 0.0, status
    fre = 0.0
    offset = 0
    index1 = k1 = index2 = k2 = jump_flag = 0
    t_flag = o_flag = j_flag = 0
    c1 = c2 = 0

    i = 0
    while i < length - 2:
        index1 = k1 = index2 = k2 = 0
        jump_flag = 0

        _index = _max_index(db_arr, length)
        _v_flag = 1
        if _index == i:
            if (db_arr[i] - _g(db_arr, i + 1) > 18
                    and db_arr[i] - _g(db_arr, i + 2) > 18):
                _v_flag = 0

        ln, index1, k1, index2, k2, jump_flag = queue_cal(
            fre_arr, db_arr, height_arr, length, i, _v_flag)
        if ln:
            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(fre_arr, i), _g(fre_arr, i + 1), _g(fre_arr, i + 2))
            if (_index == 2 and _index == i + 2
                    and _g(fre_arr, i + 2) > 220 and (not uk3 or uk3 == 5)
                    and length - 2 > 5):
                i += 2  # C: i++ + the for-increment
                continue
            if ln:
                _imax = _max_index(db_arr, length)
                if (uk1 == 1 and uk2 == 2 and uk3 == 4
                        and _imax == i + 2 and i > 0
                        and 220 < _g(fre_arr, i) < 360):
                    return _g(fre_arr, i + 1) / 2, status
            if (uk1 == 2 and uk2 == 4 and uk3 == 5 and i == 0
                    and 240 < _g(fre_arr, 2) < 255 and length > 6):
                _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    _g(fre_arr, 2), _g(fre_arr, 3), _g(fre_arr, 4))
                if uk1 == 1 and uk2 == 2 and uk3 == 3:
                    _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                        _g(fre_arr, 3), _g(fre_arr, 4), _g(fre_arr, 5))
                    return _g(fre_arr, 3) / 2, status

        if ln:
            if ln == 2:  # twoMove
                t_flag = 1
                fre, offset = queue_two_move(
                    fre_arr, db_arr, height_arr, length, i,
                    index1, k1, index2, k2, jump_flag)
                if (i == 0 and abs(_g(fre_arr, 0) - fre) < 10
                        and jump_flag == 2
                        and _g(db_arr, 2) > _g(db_arr, 0)
                        and _g(db_arr, 2) > _g(db_arr, 1)
                        and _index == 3):
                    _, lk1, lk2 = queue_fre2(_g(fre_arr, 2), _g(fre_arr, 3))
                    if lk1 == 1 and lk2 == 2:
                        fre = _g(fre_arr, 3) / 2
                if not fre:
                    if (length > 5 and _g(db_arr, i + 1) > _g(db_arr, i)
                            and c1 <= 1):
                        c1 += 1
                        i += 1
                        continue
                if not fre:  # valid 1:2
                    if k1 and k2:
                        base = _g(fre_arr, index2) / k2
                        f1, _i1 = queue_has(fre_arr, length, base, offset)
                        if f1:
                            fre = base
                        if not fre:
                            base = _g(fre_arr, index1) / k1
                            f1, _i1 = queue_has(fre_arr, length, base,
                                                offset)
                            if f1:
                                fre = base
                        if not fre:
                            _idx = (index1 + 2 if jump_flag == 1
                                    else index1 + 1)
                            if _g(db_arr, _idx) > _g(db_arr, index1):
                                fre = _g(fre_arr, _idx)
                                if (i == 0 and k1 == 3 and _idx == 2
                                        and 238 < _g(fre_arr, 2) < 260
                                        and _g(db_arr, 1) > _g(db_arr, 0)
                                        and _g(db_arr, 2) > _g(db_arr, 0)):
                                    _, lk1, lk2 = queue_fre2(
                                        _g(fre_arr, 1), _g(fre_arr, 2))
                                    if lk1 == 2 and lk2 == 3:
                                        fre = _g(fre_arr, 1) / 2
                if fre > 440:  # high-fre
                    fre = _g(fre_arr, index1) / k1
                if fre:
                    status = 1
            else:
                index2 = k2 = 0
                if not jump_flag:  # oneMove
                    o_flag = 1
                    fre, index2, k2, offset = queue_one_move(
                        fre_arr, db_arr, height_arr, length, i, index1, k1)
                    if not fre:
                        _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                            _g(fre_arr, i), _g(fre_arr, i + 1),
                            _g(fre_arr, i + 2))
                        if (length > 5 and _g(db_arr, i + 1) > _g(db_arr, i)
                                and 2 * uk2 == uk3 and uk2 != 2
                                and c2 <= 1):
                            c2 += 1
                            i += 1
                            continue
                        else:
                            if (length - i > 6 and uk1 == 1 and uk2 == 2
                                    and uk3 in (4, 6)):
                                f1, _i1 = queue_has(fre_arr, length,
                                                    _g(fre_arr, i), i + 1)
                                fre = (_g(fre_arr, i) if f1
                                       else _g(fre_arr, i + 1))
                else:  # jumpMove
                    j_flag = 1
                    fre, index2, k2, offset = queue_jump_move(
                        fre_arr, db_arr, height_arr, length, i,
                        index1, k1, jump_flag)
                if not fre:
                    if k1 and k2:
                        if index2 - index1 >= 3:
                            # C reads a fixed 3-wide window (may pass the
                            # end of lenArr; calloc'd zeros there)
                            w1 = [_g(db_arr, index1 + j) for j in range(3)]
                            w2 = [_g(db_arr, index2 + j) for j in range(3)]
                            i1 = _max_index(w1, 3) + index1
                            i2 = _max_index(w2, 3) + index2
                            if _g(db_arr, i1) - _g(db_arr, i2) > 15:
                                fre = _g(fre_arr, index1) / k1
                        base1 = _g(fre_arr, index1) / k1
                        f1, _i1 = queue_has(fre_arr, length, base1, offset)
                        if f1:
                            fre = base1
                            if (index_arr[index1] == 0
                                    and _g(fre_arr, index1) > 120):
                                pass
                            else:
                                f2, _i2 = queue_has(
                                    fre_arr, length,
                                    _g(fre_arr, index2) / k2, offset)
                                if f2 and _i2 < _i1:
                                    fre = _g(fre_arr, index2) / k2
                            if fre > 440:
                                _k, _ = cal_range_times(base1, fre)
                                if _k == 2:
                                    fre = base1
                        if not fre:
                            base2 = _g(fre_arr, index2) / k2
                            f1, _i2 = queue_has(fre_arr, length, base2,
                                                offset)
                            if f1:
                                fre = base2
                                if o_flag:
                                    _imax = _max_index(db_arr, length)
                                    if (index1 == 0 and _imax == 0
                                            and k1 == 1 and k2 == 1):
                                        _k, _ = cal_range_times(
                                            _g(fre_arr, index1),
                                            _g(fre_arr, index2))
                                        if _k in (2, 4):
                                            fre = base1
                        if not fre:
                            base2 = _g(fre_arr, index2) / k2
                            if abs(base1 - base2) < 10:  # queue error
                                fre = base1
                if fre:
                    status = 2 if o_flag else 3
            break
        i += 1

    if not fre:
        if k1 and k2:  # priority weak
            _fre1 = _g(fre_arr, index1) / k1
            _fre2 = _g(fre_arr, index2) / k2
            if index1 == index2:
                fre = _fre1
                _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    _g(fre_arr, index1), _g(fre_arr, index1 + 1),
                    _g(fre_arr, index1 + 2))
                if (uk1 == 2 and uk2 == 3 and uk3 == 4 and index1 == 0
                        and _g(db_arr, 0) > _g(db_arr, 1)
                        and _g(db_arr, 0) > _g(db_arr, 2)):
                    if fre > 130:
                        fre = _fre1
                    elif fre > 70:
                        fre = _fre2
            else:
                if k1 == k2 and index1 + 1 == index2:
                    _db1 = _g(db_arr, index1)
                    _db2 = _g(db_arr, index2)
                    fre = _fre1 if _db2 - _db1 < 8 else _fre2
        else:  # dB
            if k1:  # only one queue
                fre = _g(fre_arr, index1) / k1
                _fre1 = _g(fre_arr, index1)
                _fre2 = _g(fre_arr, index1 + 1)
                _fre3 = _g(fre_arr, index1 + 2)
                _db1 = _g(db_arr, index1)
                _db2 = _g(db_arr, index1 + 1)
                if jump_flag:
                    if jump_flag == 1:
                        _fre2 = _g(fre_arr, index1 + 2)
                        _fre3 = _g(fre_arr, index1 + 3)
                        _db2 = _g(db_arr, index1 + 2)
                    else:
                        _fre2 = _g(fre_arr, index1 + 1)
                        _fre3 = _g(fre_arr, index1 + 3)
                        _db2 = _g(db_arr, index1 + 1)
                _, us1, us2, uk1, uk2, uk3 = queue_fre3(_fre1, _fre2, _fre3)
                if (uk1 == 1 and uk2 == 2 and uk3 in (4, 6)
                        and _db2 > _db1):  # 1:2:4/1:2:6
                    fre = _g(fre_arr, index1 + 1)
                if fre < 50:
                    if _g(db_arr, index1 + 1) > _g(db_arr, index1):
                        _fre, lk1, lk2 = queue_fre2(
                            _g(fre_arr, index1 + 1),
                            _g(fre_arr, index1 + 2))
                        if lk1 == 1:
                            fre = _fre
        if fre:
            status = 4

    if fre and length >= 4:
        li1 = _max_index(db_arr, length)
        li2 = _max_index(db_arr[2:], length - 2) + 2
        if (li1 <= 1 and db_arr[li1] - db_arr[li2] > 18
                and (db_arr[0] - db_arr[li2] > 12
                     or db_arr[1] - db_arr[li2] > 12)):
            _fre, lk1, lk2 = queue_fre2(_g(fre_arr, 0), _g(fre_arr, 1))
            if (((lk1 == 1 and lk2 == 2) or (lk1 == 2 and lk2 == 3))
                    and 78 < _fre < 85):
                return _fre, status

    if fre:
        fre = _slide_valid(fre_arr, db_arr, height_arr, index_arr, length,
                           fre)

    if not fre and length >= 8:
        li1 = _max_index(db_arr, length)
        if li1 < 3:
            li2 = _max_index(db_arr[li1 + 1:], length - (li1 + 1)) + li1 + 1
            if 190 < fre_arr[li2] < 204:
                return queue_slide(fre_arr[li2:], db_arr[li2:],
                                   height_arr[li2:], index_arr[li2:],
                                   length - li2, light, valid)

    if fre:
        _imax = _max_index(db_arr, length)
        if (230 < fre_arr[_imax] < 255 and fre_arr[_imax] / fre > 3.6):
            if _imax > 0 and index_arr[_imax - 1] == 1:
                if abs(fre_arr[_imax - 1] / 2 - fre_arr[_imax] / 3) < 5:
                    return fre_arr[_imax - 1] / 2, status
            fre = fre_arr[_imax]

    if fre and light > 0.98 and length > 3:
        li1 = _max_index(db_arr, length)
        li2 = _max_index(db_arr[2:], length - 2) + 2
        if (300 < fre < 360 and li1 == 1 and li2 == 2
                and db_arr[1] - db_arr[0] < 6
                and db_arr[0] - db_arr[2] > 18
                and abs(fre - fre_arr[li1]) < 10):
            _, lk1, lk2 = queue_fre2(_g(fre_arr, 0), _g(fre_arr, 1))
            if lk1 == 1 and lk2 == 3:
                fre = _g(fre_arr, 1) / 3
    return fre, status


def trist_dispatch(fre_arr, db_arr, height_arr, length, light=0.0, valid=0):
    """__trist (_trist3.c:291): direct -> slide -> weak over one candidate
    set (frequency-ascending), with the C's dB-rank index array.
    ``valid`` carries the cascade's accumulated *valid out-value (cut's
    reject stores); direct gates on it (_queue.c:5529).
    Returns (flag, fre): flag 3/4/5 by winning strategy, 0 if none."""
    if not length:
        return 0, 0.0
    order = sorted(range(length), key=lambda j: -db_arr[j])
    index_arr = [0] * length
    for rank, j in enumerate(order):
        index_arr[j] = rank
    fre = queue_direct(fre_arr, db_arr, height_arr, index_arr, length,
                       light, valid)
    if fre:
        return 3, fre
    fre, _status = queue_slide(fre_arr, db_arr, height_arr, index_arr,
                               length, light, valid)
    if fre:
        return 4, fre
    fre = queue_weak(fre_arr, db_arr, height_arr, index_arr, length,
                     light, valid)
    if fre:
        return 5, fre
    return 0, 0.0


def queue_count(fre_arr, db_arr, height_arr, length, start, fmin, base,
                step):
    """__queue_count (_queue.c:605): count 1:1/2:2-spaced stacks on base."""
    count = 0
    i = start
    while i < length - 2:
        if _g(fre_arr, i) > fmin:
            fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(fre_arr, i), _g(fre_arr, i + 1), _g(fre_arr, i + 2))
            if fre and us1 in (1, 2) and us2 in (1, 2):
                k1, _ = cal_range_times(fre, base)
                if k1 == 1:
                    count += 1
                    i += step
        i += 1
    return count


def queue_odd98(fre_arr, db_arr, height_arr, length, start, value1):
    """__queue_odd98 (_queue.c:960): odd-harmonic count with 196-centred
    base self-correction."""
    count = 0
    corr_flag = 0
    for i in range(start, length):
        k1, t = cal_range_times(value1, _g(fre_arr, i))
        if k1 and not t:
            f = _g(fre_arr, i)
            if not corr_flag:
                if k1 in (4, 6, 8):
                    if abs(value1 * 2 - 196) > abs(f / k1 * 2 - 196):
                        value1 = f / k1
                    corr_flag = 1
            if k1 % 2 == 1 and k1 > 1:
                if k1 <= 5 and abs(value1 * k1 - f) < 6:
                    count += 1
                elif k1 <= 9 and abs(value1 * k1 - f) < 18:
                    count += 1
                elif k1 == 11 and abs(value1 * k1 - f) < 20:
                    count += 1
                elif k1 <= 19 and abs(value1 * k1 - f) < 25:
                    count += 1
                elif k1 > 19 and abs(value1 * k1 - f) < 30:
                    count += 1
    return count


def queue_multi(fre_arr, db_arr, height_arr, length, num, sub_type,
                union_type, direction):
    """__queue_multi (_queue.c:462): find a base seen in >= num stacks."""
    if length < 5 or num < 1:
        return 0.0
    step = 2 if not union_type else (1 if union_type == 1 else 0)
    idxs, ks, nums = [], [], []
    if not direction:
        i = 0
        while i < length - 2:
            _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(fre_arr, i), _g(fre_arr, i + 1), _g(fre_arr, i + 2))
            if not sub_type:
                s_flag = us1 in (1, 2) and us2 in (1, 2)
            else:
                s_flag = us1 == us2 and us1 in (1, 2)
            if _fre and s_flag:
                hit = -1
                for j in range(len(idxs)):
                    _k, _ = cal_range_times(
                        _g(fre_arr, idxs[j]) / ks[j], _fre)
                    if _k == 1:
                        hit = j
                        break
                if hit >= 0:
                    nums[hit] += 1
                    if nums[hit] == num:
                        return _fre
                else:
                    idxs.append(i)
                    ks.append(uk1)
                    nums.append(1)
                i += step
            i += 1
    return 0.0


def queue_standard(fre_arr, db_arr, height_arr, index_arr, length,
                   fre_arr2=(), db_arr2=(), height_arr2=(), length2=0,
                   fre_arr3=(), db_arr3=(), height_arr3=(), ref_length=0,
                   light=0.0, valid=0):
    """__queue_standard (_queue.c:1282): slide over the full (pre-cut)
    candidate set with string-register validators.  fre_arr/index_arr is
    the frame's cut set, fre_arr3/ref_length the full filter set."""
    fre = 0.0
    if ref_length > 3:
        order = sorted(range(ref_length), key=lambda j: -db_arr3[j])
        idx2 = [0] * ref_length
        for rank, j in enumerate(order):
            idx2[j] = rank
        fre, _status = queue_slide(fre_arr3, db_arr3, height_arr3, idx2,
                                   ref_length, light, valid)
        if fre > 240:
            pass
        elif fre > 230 and ref_length > 12:  # 2-string 230~240
            if queue_query2(fre_arr3, db_arr3, height_arr3, ref_length, 0,
                            fre / 2, fre, 0):
                fre = 0.0
        else:
            if 189 < fre < 205 and ref_length > 13:  # 3-string 197+7
                k1 = 0
                index1 = 0
                for i in range(ref_length):
                    if abs(fre * 2 - _g(fre_arr3, i)) < 10:
                        k1, index1 = 2, i
                        break
                    elif abs(fre * 3 - _g(fre_arr3, i)) < 15:
                        k1, index1 = 3, i
                        break
                if k1:
                    b = _g(fre_arr3, index1) / k1
                    if queue_query2(fre_arr3, db_arr3, height_arr3,
                                    ref_length, 0, b, b * 2, 0):
                        count1 = queue_odd98(fre_arr3, db_arr3, height_arr3,
                                             ref_length, 0, b / 2)
                        fre = b / 2 if count1 > 3 else b
                    else:
                        fre = 0.0
            elif 139 < fre < 155 and ref_length > 15:  # 4-string 147
                if not queue_query2(fre_arr3, db_arr3, height_arr3,
                                    ref_length, 0, fre, fre * 2, 0):
                    fre = 0.0
            else:
                fre = 0.0

        if 280 < fre < 310:
            if queue_query2(fre_arr3, db_arr3, height_arr3, ref_length, 0,
                            fre / 2, fre, 0):
                flag = 1
                if 190 < _g(fre_arr, 0) < 205:
                    count = queue_count(fre_arr3, db_arr3, height_arr3,
                                        ref_length, 0, 0, fre, 2)
                    if count >= 2:
                        flag = 0
                fre = fre / 2 if flag else 0.0
            else:
                fre = 0.0

        if ((190 < fre / 2 < 205 or 190 < fre / 4 < 205)
                and ref_length > 4):
            i1 = _max_index(db_arr3, ref_length)
            i2 = _max_index(db_arr3[1:], ref_length - 1) + 1
            if (179 < _g(fre_arr3, i1) < 205
                    or 179 < _g(fre_arr3, i2) < 205):
                fre = fre / 2 if 190 < fre / 2 < 205 else fre / 4
        if ((240 < fre / 2 < 255 or 240 < fre / 4 < 255)
                and ref_length > 8):
            _fre1 = queue_multi(fre_arr3, db_arr3, height_arr3, ref_length,
                                2, 0, 2, 0)
            if 240 < _fre1 < 255:
                fre = _fre1
        if (310 < fre < 350 and 100 < _g(fre_arr, 0) < 120
                and _g(db_arr, 0) - _g(db_arr, 2) > 10):
            flag = queue_query3(fre_arr3, db_arr3, height_arr3, ref_length,
                                0, _g(fre_arr, 0), fre, 0)
            if flag:
                fre = _g(fre_arr, 0)
            else:
                _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    _g(fre_arr, 0), _g(fre_arr, 1), _g(fre_arr, 2))
                if (uk1 == 1 and uk2 == 2 and uk3 == 3
                        and abs(_g(fre_arr, 0) * 2 - _g(fre_arr, 1)) < 5
                        and abs(_g(fre_arr, 0) * 3 - _g(fre_arr, 2)) < 5):
                    fre = _g(fre_arr, 0)
                else:
                    _, k1, k2 = queue_fre2(_g(fre_arr, 1), _g(fre_arr, 2))
                    if (k1 == 2 and k2 == 3
                            and abs(_g(fre_arr, 1) / 2 * 3
                                    - _g(fre_arr, 2)) < 6
                            and abs(_g(fre_arr, 0)
                                    - _g(fre_arr, 1) / 2) < 8):
                        fre = _g(fre_arr, 0)
    return fre


def trist3_resolve(fre1, db1, h1, len1, fre2, db2, h2, len2,
                   fre3, db3, h3, len3, light=0.0):
    """trist3 (_trist3.c:44): the complete FFP resolution cascade over the
    now-fully-ported strategy engine.

    Args follow the C: set 1 = full filter chain, set 2 = fast chain,
    set 3 = cut chain, each frequency-ascending.  Returns (flag, fre)
    with the C's flag codes: 6 standard, 1 cut, 2 fast,
    3/4/5 direct/slide/weak.
    """
    def rank_index(db, n):
        order = sorted(range(n), key=lambda j: -db[j])
        idx = [0] * n
        for r, j in enumerate(order):
            idx[j] = r
        return idx

    if len3:
        idx3 = rank_index(db3, len3)
        fre = queue_standard(fre3, db3, h3, idx3, len3,
                             fre2, db2, h2, len2,
                             fre1, db1, h1, len1, light, 0)
        if fre:
            return 6, fre
    # the C threads one `valid` out-pointer through the whole cascade
    # (_trist3.c:44-91): cut's reject branches store 1/3 there, and the
    # later fast (refLength>5) and direct stages gate on it
    vcell = [0]
    if len3:
        from audioflux_torch.mir._queue_cut import queue_cut
        idx3 = rank_index(db3, len3)
        fre = queue_cut(fre3, db3, h3, idx3, len3,
                        fre2, db2, h2, len2,
                        fre1, db1, h1, len1, light, 0, valid_out=vcell)
        if fre:
            return 1, fre
    if len2:
        idx2 = rank_index(db2, len2)
        fre = queue_fast(fre2, db2, h2, idx2, len2,
                         fre1, db1, h1, len1, light, vcell[0])
        if fre:
            return 2, fre
    if len1:
        return trist_dispatch(fre1, db1, h1, len1, light, vcell[0])
    return 0, 0.0


def _arr_cut(arr, length, value):
    """__arr_cut (_queue.c:7722): index of first element > value."""
    for i in range(length):
        if _g(arr, i) > value:
            return i
    return length


def _check_fre(fre1, fre2, fre3):
    """__checkFre (_queue.c:7645): blend the two closest of three bases."""
    a = sorted([fre1, fre2, fre3])
    sub1 = a[1] - a[0]
    sub2 = a[2] - a[1]
    # the C's `if(sub1>base||sub2>base||1)` is always true
    return (a[0] + a[1]) / 2 if sub1 < sub2 else (a[1] + a[2]) / 2


def queue_query(fre_arr, db_arr, height_arr, length, value):
    """__queue_query (_queue.c:636): odd harmonic >=5 presence."""
    for i in range(length):
        k, t = cal_range_times(value, _g(fre_arr, i))
        if k and not t:
            flag = 0
            f = _g(fre_arr, i)
            if k in (5, 7, 9, 11, 13):
                if k == 5 and abs(value * k - f) < 6:
                    flag = 1
                elif k <= 9 and abs(value * k - f) < 12:
                    flag = 1
                elif k == 11 and abs(value * k - f) < 18:
                    flag = 1
                elif k == 13 and abs(value * k - f) < 20:
                    flag = 1
            if flag:
                return 1
    return 0


def queue_four(fre_arr, db_arr, height_arr, length, value):
    """__queue_four (_queue.c:669): 4 consecutive harmonics above value."""
    start = -1
    for i in range(length):
        if abs(_g(fre_arr, i) - value) < 10:
            start = i
            break
    if start == -1 or start + 3 > length - 1:
        return 0
    flag = 1
    j = 2
    for i in range(start + 1, length):
        if j >= 5:
            break
        _, k1, k2 = queue_fre2(_g(fre_arr, start), _g(fre_arr, i))
        if not (k1 == 1 and k2 == j):
            flag = 0
            break
        j += 1
    return flag


def queue_bear(fre_arr, db_arr, height_arr, length, fmin, base, index=0):
    """__queue_bear (_queue.c:562). -> (flag, index)."""
    start = index if index >= 0 else 0
    for i in range(start, length - 2):
        if _g(fre_arr, i) > fmin:
            fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(fre_arr, i), _g(fre_arr, i + 1), _g(fre_arr, i + 2))
            if fre and us1 in (1, 2) and us2 in (1, 2):
                k1, _ = cal_range_times(fre, base)
                if k1 == 1:
                    return 1, i
    return 0, index


def queue_valid98(fre_arr, db_arr, height_arr, length, start, value1,
                  strict):
    """__queue_valid98 (_queue.c:826): odd-harmonic count with dB-shape
    strictness gates."""
    count = 0
    for i in range(start, length):
        k1, t = cal_range_times(value1, _g(fre_arr, i))
        if k1 and not t:
            f = _g(fre_arr, i)
            if k1 == 3 and i - 1 >= 0:
                if _g(db_arr, i - 1) - _g(db_arr, i) > 24:
                    continue
            if k1 not in (3, 5, 7, 9, 11, 13, 15, 17, 19):
                continue

            def _strict_ok(lo_hi_gate, deep_gate):
                if i == start and i < length - 1:
                    return _g(db_arr, i + 1) - _g(db_arr, i) < 3
                if i == length - 1 and i > 0:
                    return _g(db_arr, i - 1) - _g(db_arr, i) < 3
                if 0 < i < length - 1:
                    if (_g(db_arr, i) - _g(db_arr, i - 1) > lo_hi_gate
                            or _g(db_arr, i) - _g(db_arr, i + 1)
                            > lo_hi_gate):
                        if (deep_gate
                                and _g(db_arr, i - 1) - _g(db_arr, i)
                                > deep_gate):
                            return _g(db_arr, i) - _g(db_arr, i + 1) > 6
                        return True
                return False

            if k1 <= 5 and abs(value1 * k1 - f) < 6:
                count += 1 if (not strict or _strict_ok(2, 0)) else 0
            elif k1 <= 9 and abs(value1 * k1 - f) < 18:
                count += 1 if (not strict or _strict_ok(2, 24)) else 0
            elif k1 == 11 and abs(value1 * k1 - f) < 20:
                count += 1 if (not strict or _strict_ok(2, 0)) else 0
            elif k1 <= 19 and abs(value1 * k1 - f) < 25:
                count += 1 if (not strict or _strict_ok(3, 18)) else 0
    return count


def queue_cut_valid(fre_arr, db_arr, length, o_flag, mode,
                    fre_arr2, db_arr2, length2, fre_arr3, db_arr3, length3):
    """__queue_cutValid (_queue.c:1181): probe for the /2 sub-octave."""
    if mode == 0:
        _fre, _db, _len = fre_arr2, db_arr2, length2
    else:
        _fre, _db, _len = fre_arr3, db_arr3, length3
    fre = _g(fre_arr, 0)
    count = 0
    for i in range(_len):
        k, t = cal_range_times(_g(fre_arr, 0) / 2, _g(_fre, i))
        if o_flag and not mode:
            if k == 1 and length3 < 6:
                count += 1
        if k and not t:
            if ((not mode and k in (3, 5, 7))
                    or (mode and k in (3, 5, 7, 9, 11))):
                flag = 0
                half = _g(fre_arr, 0) / 2
                if k <= 5 and abs(half * k - _g(_fre, i)) < 6:
                    flag = 1
                elif k <= 9 and abs(half * k - _g(_fre, i)) < 12:
                    flag = 1
                elif k == 11 and abs(half * k - _g(_fre, i)) < 18:
                    flag = 1
                # C reads _dbArr[i-1] unguarded at i=0 (one element before
                # the frame row: zero in the FFP layout); mirrored via _g
                if flag and (_g(_db, i - 1) - _g(_db, i) < 12
                             or _g(_db, i + 1) - _g(_db, i) < 12):
                    count += 1
    if count == 1 and o_flag and length3 > 5:
        for i in range(3, _len - 2):
            if i > 5:
                break
            _f, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(_fre, i), _g(_fre, i + 1), _g(_fre, i + 2))
            if us1 == 1 and us1 == us2:
                _k, _ = cal_range_times(_f, _g(fre_arr, 0))
                if _k == 2 and abs(_f - _g(fre_arr, 0) / 2) < 8:
                    count += 1
                    break
    if count >= 2:
        fre = _g(fre_arr, 0) / 2
    return fre
