"""Exact port of __queue_cut (_queue.c:1570-5113).

Counterpart of ``audioflux_tpu/mir/_queue_cut.py``: a verbatim copy, only
its import paths changed.

The largest _queue strategy: resolve the frame's cut-filtered candidate
set against the fast set (fre_arr2) and the full filter set (fre_arr3)
through several hundred string-instrument pattern rules.  Statement-level
port; fuzz-verified against the exported C symbol
(tests/test_queue_util.py).  See ``_queue_util`` for the shared
primitives and the C's out-of-bounds-read conventions (zeros past
``lenArr``, mirrored by ``_g``).

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

from audioflux_torch.mir._queue_util import (
    _arr_cut, _check_fre, _g, _max_index, cal_range_times, queue_bear,
    queue_count, queue_cut_valid, queue_fast, queue_four, queue_fre2,
    queue_fre3, queue_multi, queue_odd98, queue_query, queue_query2,
    queue_query3, queue_valid98)

__all__ = ["queue_cut"]


def queue_cut(fre_arr, db_arr, height_arr, index_arr, length,
              fre_arr2=(), db_arr2=(), height_arr2=(), length2=0,
              fre_arr3=(), db_arr3=(), height_arr3=(), ref_length=0,
              light=0.0, valid=0, valid_out=None):
    """``valid_out``: optional 1-element list mirroring the C's ``*valid``
    out-pointer — several reject branches store 1 or 3 there, and trist3's
    later cascade stages (fast with refLength>5, direct) gate on it
    (_queue.c:5132, :5529)."""
    if valid_out is None:
        valid_out = [0]
    f, d, h = fre_arr, db_arr, height_arr
    f2, d2, h2 = fre_arr2, db_arr2, height_arr2
    f3, d3, h3 = fre_arr3, db_arr3, height_arr3
    fre = 0.0

    index1 = _max_index(d, length)

    if ((abs(_g(d, 2) - _g(d, 3)) < 4 or _g(d, 2) > _g(d, 3))
            and _g(d, 2) > _g(d, 0) and _g(d, 2) > _g(d, 1)
            and _g(d, 3) > _g(d, 0) and _g(d, 3) > _g(d, 1)):
        _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
            _g(f, 0), _g(f, 2), _g(f, 3))
        _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(
            _g(f, 0), _g(f, 1), _g(f, 2))
        if uk1 == 1 and uk2 == 2 and uk3 == 3:
            if (abs(_fre * uk2 - _g(f, 2)) < 5
                    and abs(_fre * uk3 - _g(f, 3)) < 5):
                if vk2 != 3:
                    return _g(f, 2) / uk2
                elif _g(f, 0) < 100:
                    return _g(f, 2) / uk2
    elif (_g(d, 0) - _g(d, 1) > 12 and _g(d, 2) - _g(d, 1) > 12
          and 160 < _g(f, 1) < 180):
        _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
            _g(f, 0), _g(f, 2), _g(f, 3))
        if uk1 == 1 and uk2 == 2 and uk3 == 3:
            if (abs(_fre * uk2 - _g(f, 2)) < 5
                    and abs(_fre * uk3 - _g(f, 3)) < 5):
                return _g(f, 2) / uk2
    elif 103 < _g(f, 0) < 115:
        if not _max_index(d, length):
            _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(f, 0), _g(f, 2), _g(f, 3))
            if uk1 == 1 and uk2 == 3 and uk3 == 4:
                if (abs(_fre * uk2 - _g(f, 2)) < 5
                        and abs(_fre * uk3 - _g(f, 3)) < 5):
                    if (_g(f, 0) * 2 - _g(f, 1)) < 15:
                        return _g(f, 2) / uk2
            elif uk1 == 1 and uk2 == 4 and uk3 == 6:
                if (abs(_fre * uk2 - _g(f, 2)) < 5
                        and abs(_fre * uk3 - _g(f, 3)) < 5):
                    if (_g(f, 0) * 2 - _g(f, 1)) < 15:
                        return _g(f, 2) / uk2

    _, us1, us2, uk1, uk2, uk3 = queue_fre3(_g(f, 0), _g(f, 1), _g(f, 2))
    vs1 = vs2 = vk1 = vk2 = vk3 = 0
    if uk1:
        _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(
            _g(f, 1), _g(f, 2), _g(f, 3))
        if vk1:
            # C: `uk1>=1&uk1<=2&uk1+1==uk2` — bitwise & on 0/1 ints,
            # semantically the same conjunction here
            if ((uk1 >= 1) & (uk1 <= 2) & (uk1 + 1 == uk2)
                    and uk2 + 1 == uk3 and uk3 + 1 == vk3):
                fre = _g(f, 1) / uk2
                if uk1 == 1:
                    if (_g(d, 0) > _g(d, 1)
                            and (_g(d, 1) > _g(d, 2)
                                 and _g(d, 1) > _g(d, 3))):
                        _fre1 = queue_cut_valid(f, d, length, 0, 1,
                                                f2, d2, length2,
                                                f3, d3, ref_length)
                        _, k1, k2 = queue_fre2(_fre1, fre)
                        if not (k1 == 1 and k1 == k2):
                            fre = _fre1
                    else:
                        if (index1 == 1 and 190 < _g(f, index1) < 204
                                and _g(d, 2) < _g(d, 0)
                                and _g(h, 2) < 15):
                            return _g(f, 1)
                        elif (index1 == 1 and 190 < _g(f, index1) < 204
                              and _g(d, 1) - _g(d, 2) > 18):
                            count1 = queue_odd98(f3, d3, h3, ref_length, 0,
                                                 _g(f, 1) / 2)
                            if ((count1 >= 2 and ref_length < 10)
                                    or count1 >= 3):
                                return _g(f, 1) / 2
                            if ref_length < 7:
                                return _g(f, 1) / 2
                            else:
                                flag = queue_valid98(f3, d3, h3, ref_length,
                                                     0, _g(f, 1) / 2, 1)
                                count1 = queue_odd98(f3, d3, h3, ref_length,
                                                     0, _g(f, 1) / 2)
                                flag1 = 0
                                if count1 >= 2 and ref_length < 10:
                                    flag1 = 1
                                elif count1 > 3:
                                    flag1 = 1
                                elif (_g(d, 1) - _g(d, 0) < 6
                                      and ref_length < 10 and count1):
                                    flag1 = 1
                                if not flag and not flag1:
                                    return _g(f, 1)
                        elif 150 < _g(f, 0) < 180:
                            if queue_query2(f3, d3, h3, ref_length, 0,
                                            _g(f, 0) / 2, _g(f, 0), 1):
                                return _g(f, 0) / 2
                return fre
            if uk1 == 2 and uk2 == 3 and uk3 == 4 and vk3 == 7:
                return _g(f, 0) / uk1
            if (uk1 == 1 and uk2 == 2 and uk3 == 3
                    and vk1 == 4 and vk2 == 6 and vk3 == 7):
                if (_g(d, 0) > _g(d, 1) and _g(d, 1) > _g(d, 2)
                        and _g(d, 2) > _g(d, 3)
                        and 100 < _g(f, 0) < 120):
                    fre = _g(f, 1) / 2
                elif (index1 == 1 and _g(d, index1) - _g(d, 3) > 20
                      and _g(f, 1) < 190):
                    fre = _g(f, 1) / 2
                elif (index1 in (1, 2) and _g(d, 1) - _g(d, 3) > 12
                      and _g(d, 2) - _g(d, 3) > 12
                      and 150 < _g(f, 1) < 180):
                    fre = _g(f, 1) / 2
                else:
                    if (_g(d, 0) - _g(d, 3) > 20
                            and (_g(d, 1) - _g(d, 3) > 20
                                 or _g(d, 0) - _g(d, 1) > 20)):
                        fre = _g(f, 0)
                    elif (_g(d, 0) - _g(d, 3) > 18
                          and _g(d, 1) - _g(d, 3) > 12
                          and _g(d, 2) > _g(d, 3)
                          and _g(f, 0) > 220):
                        fre = _g(f, 1) / 2
                    else:
                        fre = _g(f, 0) / 2
                return fre
            if ((uk1 == 2 and uk2 == 3 and uk3 == 6
                 and vk1 == 3 and vk2 == 6 and vk3 == 7)
                    or (uk1 == 2 and uk2 == 3 and uk3 == 5
                        and vk1 == 3 and vk2 == 5 and vk3 == 6)
                    or (uk1 == 1 and uk2 == 2 and uk3 == 6
                        and vk1 == 2 and vk2 == 6 and vk3 == 7)
                    or (uk1 == 1 and uk2 == 2 and uk3 == 5
                        and vk1 == 2 and vk2 == 5 and vk3 == 6)):
                if ((uk1 == 2 and uk2 == 3 and uk3 == 5
                     and vk1 == 3 and vk2 == 5 and vk3 == 6)
                        and _g(d, 1) > _g(d, 3) and _g(d, 3) > _g(d, 0)
                        and _g(d, 3) > _g(d, 2)
                        and 140 < _g(f, 1) < 155):
                    fre = _g(f, 1)
                else:
                    fre = _g(f, 0) / uk1
                return fre

    if (uk1 == 1 and uk2 == 2 and uk3 == 4
            and vk1 == 1 and vk2 == 2 and vk3 == 4
            and index1 == 2 and 103 < _g(f, 1) < 120):
        return _g(f, 2) / 2

    if not uk1:
        _, ts1, ts2, tk1, tk2, tk3 = queue_fre3(
            _g(f, 1), _g(f, 2), _g(f, 3))
        if (tk1 == 2 and tk2 == 3 and tk3 == 4
                and 100 < _g(f, 1) / 2 < 120):
            return _g(f, 1) / 2
        if (tk1 == 1 and tk2 == 2 and tk3 == 3
                and 100 < _g(f, 1) / 2 < 120):
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                            _g(f, 1), 0):
                return _g(f, 1) / 2
        if (tk1 == 2 and tk2 == 4 and tk3 == 7
                and 100 < _g(f, 1) / 2 < 120):
            return _g(f, 1) / 2
        if (tk1 == 2 and tk2 == 3 and tk3 == 4 and index1 == 1
                and 85 < _g(f, 0) < 95
                and 150 < _g(f, 1) < 170):
            return _g(f, 1) / 2
        if index1 == 2 and _g(d, 2) - _g(d, 1) > 18:
            _, ts1, ts2, tk1, tk2, tk3 = queue_fre3(
                _g(f, 0), _g(f, 2), _g(f, 3))
            if (tk1 == 1 and tk2 == 2 and tk3 == 3
                    and 140 < _g(f, 0) < 154):
                return _g(f, 2) / 2
            if (tk1 == 1 and tk2 == 3 and tk3 == 4
                    and _g(f, 2) > 200 and _g(f, 0) < 210):
                return _g(f, 0)
        if (tk1 == 1 and tk2 == 2 and tk3 == 4 and index1 == 3
                and 220 < _g(f, 1) < 360):
            return _g(f, 2) / 2
        if (tk1 == 1 and tk2 == 2 and tk3 == 4 and index1 == 2
                and 140 < _g(f, 2) / 2 < 155):
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 2) / 2,
                            _g(f, 2), 0):
                return _g(f, 2) / 2
        if (tk1 == 1 and tk2 == 2 and tk3 == 4 and index1 == 2
                and 105 < _g(f, 2) / 2 < 115):
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 2) / 2,
                            _g(f, 2), 0):
                return _g(f, 2) / 2
        _, k1, k2 = queue_fre2(_g(f, 1), _g(f, 2))
        if (index1 == 2 and _g(d, 2) - _g(d, 1) > 18
                and 300 < _g(f, 2) < 350):
            _, _k1, _k2 = queue_fre2(_g(f, 0), _g(f, 2))
            if (_k1 == 1 and _k2 == 3
                    and abs(_g(f, 0) * 3 - _g(f, 2)) < 4):
                if queue_query3(f3, d3, h3, ref_length, 0, _g(f, 0),
                                _g(f, 2), 0):
                    return _g(f, 2) / 3
            return _g(f, 2)
        if (k1 == 2 and k2 == 3 and 200 < _g(f, 1) < 240
                and abs(_g(f, 1) / 2 * 3 - _g(f, 2)) < 4
                and _g(d, 1) - _g(d, 2) > -10):
            if (abs(_g(f, 0) - _g(f, 1) / 2) < 15
                    or 90 < _g(f, 0) < 100):
                return _g(f, 1) / 2
        if (index1 == 0 and _g(d, 1) > _g(d, 3) and _g(d, 2) > _g(d, 3)
                and 100 < _g(f, 2) / 3 < 120):
            _, k1, k2 = queue_fre2(_g(f, 0), _g(f, 1))
            if (k1 == 1 and k2 == 2
                    and abs(_g(f, 1) / 2 - _g(f, 0)) < 6):
                _, tq1, tq2 = queue_fre2(_g(f, 0), _g(f, 2))
                if tq1 == 1 and tq2 == 3:
                    return _g(f, 2) / 3
        if (index1 == 0 and _g(d, 2) > _g(d, 1)
                and _g(d, 3) > _g(d, 1)):
            _, ts1, ts2, tk1, tk2, tk3 = queue_fre3(
                _g(f, 0), _g(f, 2), _g(f, 3))
            if (tk1 == 1 and tk2 == 2 and tk3 == 3
                    and 200 < _g(f, 2) < 240):
                return _g(f, 0)
        if (index1 in (0, 1) and abs(_g(d, 0) - _g(d, 1)) < 3
                and _g(d, 0) > _g(d, 2)
                and _g(d, 1) > _g(d, 2)):
            if (110 < _g(f, 0) < 120 and 220 < _g(f, 1) < 240
                    and 315 < _g(f, 2) < 345 and 420 < _g(f, 3) < 460):
                return _g(f, 2) / 3
        if (index1 == 1 and tk1 == 1 and tk2 == 2 and tk3 == 3
                and 230 < _g(f, 2) / 2 < 255):
            return _g(f, 2) / 2
        if (index1 == 2 and tk1 == 1 and tk2 == 2 and tk3 in (4, 6)
                and 95 < _g(f, 2) / 2 < 105):
            flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                 _g(f, 2) / 2, 1)
            if not flag and ref_length < 8:
                if queue_odd98(f3, d3, h3, ref_length, 0,
                               _g(f, 2) / 2) >= 2:
                    flag = 1
            return _g(f, 2) / 2 if flag else _g(f, 2)
        if (index1 == 1 and tk1 == 2 and tk2 == 3 and tk3 == 6
                and 95 < _g(f, 1) / 2 < 105):
            flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                 _g(f, 1) / 2, 1)
            count1 = queue_odd98(f3, d3, h3, ref_length, 0, _g(f, 1) / 2)
            if not flag and ref_length < 10:
                count1 = queue_odd98(f3, d3, h3, ref_length, 0,
                                     _g(f, 1) / 2)
                if count1 >= 2:
                    flag = 1
            return _g(f, 1) / 2 if (flag or count1 > 3) else _g(f, 1)
        if (index1 == 1 and tk1 == 2 and tk2 == 3 and tk3 == 4
                and 95 < _g(f, 1) / 2 < 105
                and _g(f, 0) < 100):
            flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                 _g(f, 1) / 2, 1)
            if not flag and ref_length < 8:
                if queue_odd98(f3, d3, h3, ref_length, 0,
                               _g(f, 1) / 2) >= 2:
                    flag = 1
            return _g(f, 1) / 2 if flag else _g(f, 3) / 2
        if (index1 == 1 and tk1 == 1 and tk2 == 2 and tk3 == 3
                and 95 < _g(f, 1) / 2 < 105
                and _g(f, 0) < 110):
            flag = queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                                _g(f, 1), 1)
            if flag:
                c1 = queue_count(f3, d3, h3, ref_length, 0,
                                 _g(f, 1) / 2 * 11 + 10, _g(f, 1) / 2, 0)
                c2 = queue_count(f3, d3, h3, ref_length, 0,
                                 _g(f, 1) / 2 * 11 + 10, _g(f, 1), 2)
                if not c1 and c2 >= 1:
                    flag = 0
                if flag:
                    flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                         _g(f, 1) / 2, 1)
            if not flag and ref_length < 8:
                if queue_odd98(f3, d3, h3, ref_length, 0,
                               _g(f, 1) / 2) >= 2:
                    flag = 1
            return _g(f, 1) / 2 if flag else _g(f, 2) / 2
        if (index1 == 2 and not tk1 and 95 < _g(f, 2) / 2 < 105
                and 95 < _g(f, 1) < 106):
            _, _k1, _k2 = queue_fre2(_g(f, 2), _g(f, 3))
            if (_k1 == 1 and _k2 == 2
                    and abs(_g(f, 2) * 2 - _g(f, 3)) < 5):
                flag = queue_query2(f3, d3, h3, ref_length, 0,
                                    _g(f, 2) / 2, _g(f, 2), 1)
                if not flag and ref_length < 8:
                    if queue_odd98(f3, d3, h3, ref_length, 0,
                                   _g(f, 2) / 2) >= 2:
                        flag = 1
                return _g(f, 2) / 2 if flag else _g(f, 3) / 2
        if (index1 == 1 and not tk1 and _g(f, 2) > _g(f, 0) * 6
                and 95 < _g(f, 1) / 2 < 105
                and 92 < _g(f, 0) < 106):
            _, _k1, _k2 = queue_fre2(_g(f, 0), _g(f, 1))
            if _k1 == 1 and _k2 == 2:
                flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                     _g(f, 1) / 2, 1)
                if not flag and ref_length < 8:
                    _, _k1, _k2 = queue_fre2(_g(f, 0), _g(f, 2))
                    if _k1 == 1:
                        if (abs(_g(f, 1) - 196)
                                < abs(_g(f, 2) / _k2 * 2 - 196)):
                            _fre = _g(f, 1) / 2
                        else:
                            _fre = _g(f, 2) / _k2
                        if queue_odd98(f3, d3, h3, ref_length, 0,
                                       _fre) >= 2:
                            flag = 1
                return _g(f, 1) / 2 if flag else _g(f, 1)
        if (index1 == 1 and not tk1 and 95 < _g(f, 1) / 2 < 105
                and 95 < _g(f, 0) < 106):
            _, _k1, _k2 = queue_fre2(_g(f, 1), _g(f, 2))
            if (_k1 == 1 and _k2 == 3
                    and abs(_g(f, 1) * 3 - _g(f, 2)) < 8):
                flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                     _g(f, 1) / 2, 1)
                if not flag and ref_length < 8:
                    if queue_odd98(f3, d3, h3, ref_length, 0,
                                   _g(f, 1) / 2) >= 2:
                        flag = 1
                return _g(f, 1) / 2 if flag else _g(f, 2) / 3

    if (not uk1 and not vk1 and index1 in (0, 1)
            and 179 < _g(f, 1) < 190 and 190 < _g(f, 2) / 2 < 205):
        _, k1, k2 = queue_fre2(_g(f, 2), _g(f, 3))
        if k1 == 1 and k2 == 2 and abs(_g(f, 2) * 2 - _g(f, 3)) < 5:
            return _g(f, 2) / 2
        elif k1 == 2 and k2 == 3 and abs(_g(f, 2) / 2 * 3 - _g(f, 3)) < 5:
            return _g(f, 2) / 2

    if (uk1 == 1 and uk2 == 2 and uk3 == 4
            and vk1 == 2 and vk2 == 4 and vk3 == 5):
        if index1 == 1 and 190 < _g(f, index1) < 204:
            return _g(f, 0)
        if index1 == 2 and 105 < _g(f, 1) / 2 < 115:
            return _g(f, 1) / 2

    if uk1 == 1 and uk2 == 2 and uk3 == 4:
        if index1 == 2 and 185 < _g(f, 0) < 205:
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                            _g(f, 1), 0):
                return _g(f, 1) / 2
        if vk3 == 3 and index1 == 1 and 94 < _g(f, 0) < 120:
            flag = queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                                _g(f, 1), 0)
            if flag:
                if 207 < _g(f, 1) < 230:
                    return _g(f, 1) / 2
                else:
                    count1 = queue_odd98(f3, d3, h3, ref_length, 0,
                                         _g(f, 1) / 2)
                    if count1 >= 3:
                        return _g(f, 1) / 2
                    c1 = queue_count(f3, d3, h3, ref_length, 0,
                                     _g(f, 1) / 2 * 13 + 20,
                                     _g(f, 1) / 2, 0)
                    c2 = queue_count(f3, d3, h3, ref_length, 0,
                                     _g(f, 1) / 2 * 13 + 20, _g(f, 1), 1)
                    if not c1 and c2 >= 1:
                        return _g(f, 2) / 2
                    flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                         _g(f, 1) / 2, 1)
                    if not flag:
                        return _g(f, 2) / 2
            flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                 _g(f, 1) / 2, 1)
            if not flag:
                return _g(f, 2) / 2
            flag, _idx = queue_bear(f3, d3, h3, ref_length,
                                    _g(f, 1) / 2 * 13, _g(f, 1) / 2, 0)
            if flag:
                return _g(f, 1) / 2

    if (uk1 == 1 and uk2 == 2 and uk3 == 4
            and not (vk1 == 2 and vk2 == 4 and vk3 == 5)):
        if (index1 == 1 and _g(d, 1) - _g(d, 0) > 15
                and 100 < _g(f, index1) < 120):
            return _g(f, 2) / 2

    if (uk1 == 1 and uk2 == 2 and uk3 == 3
            and ((_g(d, 1) - _g(d, 0) < 6 and _g(d, 1) - _g(d, 2) > 8)
                 or (_g(d, 0) - _g(d, 1) > 5 and _g(d, 1) > _g(d, 2)))
            and 95 < _g(f, 0) < 105):
        return _g(f, 1) / 2

    if uk1 == 1 and uk2 == 2 and uk3 in (4, 6) and index1 == 1:
        if (vk1 == 2 and vk2 == 4 and vk3 == 5
                and abs(_g(f, 0) * 2 - _g(f, 1)) < 5 and _g(f, 0) < 95
                and _g(d, 1) - _g(d, 0) < 12 and _g(d, 0) > _g(d, 2)
                and _g(d, 0) > _g(d, 3)):
            return _g(f, 1) / 2
        if (vk1 == 1 and vk2 == 2 and _g(d, 1) - _g(d, 0) > 24
                and 190 < _g(f, 1) < 205):
            return _g(f, 2) / 2
        if 140 < _g(f, 1) / 2 < 155:
            return _g(f, 1) / 2
        elif 190 < _g(f, 1) / 2 < 205:
            return _g(f, 1) / 2
        flag = 0
        flag1 = 0
        if 105 < _g(f, 1) / 2 < 115:
            flag = 1
        elif 240 < _g(f, 1) / 2 < 255:
            flag = 1
        cut_len = _arr_cut(f3, ref_length, _g(f, 1) * 6)
        _fre = _g(f, 1) / 2
        if (abs(_g(f, 0) * uk3 - _g(f, 2))
                < abs(_g(f, 1) * uk3 / 2 - _g(f, 2))):
            _fre = _g(f, 0)
        if 190 < _g(f, 1) < 205:
            flag = queue_valid98(f3, d3, h3, ref_length, 0, _fre, 1)
            count1 = queue_odd98(f3, d3, h3, ref_length, 0, _fre)
            if _g(d, 1) - _g(d, 2) > 20:
                flag = 0
            if count1 >= 2 and ref_length < 8:
                flag1 = 1
            elif count1 > 3:
                flag1 = 1
            elif (_g(d, 1) - _g(d, 0) < 6 and ref_length < 10
                  and count1):
                flag1 = 1
        else:
            flag = queue_query2(f3, d3, h3, ref_length, 0, _fre,
                                _fre * 2, 0 if flag else 1)
        if not flag and cut_len < 6 and 105 < _g(f, 1) / 2 < 115:
            flag = queue_count(f3, d3, h3, ref_length, 0, _g(f, 1) * 7,
                               _fre, 0)
        if flag or flag1:
            return _g(f, 1) / 2
        else:
            return _g(f, 2) / (uk3 // 2)

    if uk1 == 1 and uk2 == 3 and uk3 == 6 and 95 < _g(f, 0) < 105:
        if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                        _g(f, 1), 1):
            return _g(f, 1) / 2
        elif queue_query3(f3, d3, h3, ref_length, 0, _g(f, 0),
                          _g(f, 1), 1):
            return _g(f, 1) / 3
        else:
            return _g(f, 2) / 2

    if uk1 == 1 and uk2 == 2 and uk3 == 3 and 280 < _g(f, 2) < 310:
        count1 = queue_odd98(f3, d3, h3, ref_length, 0, _g(f, 1) / 2)
        flag = queue_query3(f3, d3, h3, ref_length, 0, _g(f, 0),
                            _g(f, 2), 1)
        if flag or index1 == 1:
            flag = queue_valid98(f3, d3, h3, ref_length, 0,
                                 _g(f, 1) / 2, 1)
            flag1 = 0
            if count1 >= 2 and ref_length < 8:
                flag1 = 1
            elif count1 >= 3:
                flag1 = 1
            elif (_g(d, 1) - _g(d, 0) < 6 and ref_length < 10
                  and count1):
                flag1 = 1
            if (flag or flag1
                    or (vk1 == 2 and vk2 == 3 and vk3 in (5, 7))
                    or (index1 == 1 and _g(d, 1) - _g(d, 2) > 18
                        and (_g(d, 2) - _g(d, 3) > 2
                             or (_g(d, 2) > _g(d, 3)
                                 and abs(_g(f3, 2) - _g(f, 2))
                                 < 10)))):
                return _g(f, 1) / 2
            else:
                return _g(f, 1)
        else:
            return _g(f, 2)

    if (uk1 == 2 and uk2 == 3 and uk3 == 6 and index1 >= 1
            and _g(d, index1) - _g(d, 1) < 3 and _g(d, 1) > _g(d, 0)
            and 95 < _g(f, 0) / 2 < 105):
        if queue_query3(f3, d3, h3, ref_length, 0, _g(f, 0) / 2,
                        _g(f, 1), 1):
            return _g(f, 0) / 2
        else:
            return _g(f, 2) / 2

    if (not uk1 and not vk1 and index1 == 1
            and 280 < _g(f, 1) / 2 < 310):
        _, k1, k2 = queue_fre2(_g(f, 1), _g(f, 2))
        if k1 == 2 and k2 == 3 and abs(_g(f, 1) / 2 * 3 - _g(f, 2)) < 5:
            return _g(f, 1) / 2

    if (index1 <= 2 and 280 < _g(f, index1) < 310
            and 280 < _g(f, index1 + 1) / 2 < 310):
        if index1 == 2 and 140 < _g(f, 1) < 155:
            pass
        else:
            count = queue_count(f3, d3, h3, ref_length, 0, 0,
                                _g(f, index1), 2)
            if count >= 2:
                return _g(f, index1 + 1) / 2

    if (uk1 == 1 and uk2 == 3 and uk3 == 6
            and vk1 == 3 and vk2 == 6 and vk3 == 7):
        if 75 < _g(f, 0) < 90:
            return _g(f, 1) / 3

    if uk1 == 2 and uk2 == 4 and uk3 == 5:
        if index1 == 0 and 190 < _g(f, index1) < 204:
            _flag = 0
            for i in range(ref_length):
                if abs(_g(f, 2) - _g(f3, i)) < 1:
                    _flag = 1
                    break
            return _g(f, 0) / 2 if _flag else _g(f, 0)
        elif 280 < _g(f, 0) < 310:
            return _g(f, 0) / 2

    if uk1 == 1 and uk2 == 4 and uk3 == 5:
        if index1 == 0 and 150 < _g(f, 0) < 180:
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(f, index1) / 2, _g(f, index1), 1):
                return _g(f, index1) / 2
        if _g(d, 0) - _g(d, 1) > 15:
            return _g(f, 0)

    if uk1 == 1 and uk2 == 2 and uk3 == 4 and vk3 == 3:
        if 190 < _g(f, 1) < 204 and _g(d, 0) - _g(d, 1) < 3:
            if abs(_g(f, 0) * 2 - _g(f, 1)) < 5:
                if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                                _g(f, 1), 1):
                    return _g(f, 1) / 2
                else:
                    return _g(f, 2) / 2
            else:
                if _g(d, 1) > _g(d, 2) and _g(d, 1) > _g(d, 3):
                    return _g(f, 1)
                elif _g(d, 2) > _g(d, 1) and _g(d, 2) > _g(d, 3):
                    return _g(f, 1)
        if 190 < _g(f, 1) < 204:
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                            _g(f, 1), 2):
                return _g(f, 1) / 2
            else:
                return _g(f, 2) / 2

    if uk1 == 1 and uk2 == 2 and uk3 == 4 and vk3 == 6:
        if 190 < _g(f, 1) < 204:
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 1) / 2,
                            _g(f, 1), 1):
                return _g(f, 1) / 2
            else:
                return _g(f, 2) / 2

    if uk1 == 1 and uk2 == 4 and uk3 == 6:
        if 190 < _g(f, 1) / 2 < 204:
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 0),
                            _g(f, 1) / 2, 1):
                return _g(f, 0)
            else:
                return _g(f, 1) / 2

    if ((uk1 == 1 and uk2 == 2 and uk3 == 3 and vk3 == 6)
            or (uk1 == 1 and uk2 == 2 and uk3 == 4 and vk3 == 3)):
        if 75 < _g(f, 0) < 90 and uk3 == 3:
            return _g(f, 1) / 2
        if (95 < _g(f, 0) < 105 and uk3 == 3
                and index1 in (2, 3)):
            if index1 == 2 and 280 < _g(f, 2) < 310:
                if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 2) / 2,
                                _g(f, 2), 0):
                    return _g(f, 2) / 2
            if queue_query3(f3, d3, h3, ref_length, 0, _g(f, 0),
                            _g(f, 2), 1):
                return _g(f, 1) / 2
            else:
                return _g(f, 3) / 2
        if index1 == 0 and 150 < _g(f, 0) < 180:
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(f, index1) / 2, _g(f, index1), 1):
                return _g(f, index1) / 2
        if (_g(d, 0) > _g(d, 1)
                and (_g(d, 1) > _g(d, 2) and _g(d, 1) > _g(d, 3))):
            return queue_cut_valid(f, d, length, 0, 0, f2, d2, length2,
                                   f3, d3, ref_length)
        else:
            _index = _max_index(d, length)
            if (_index == 2 and uk3 == 3 and _g(d, 3) > _g(d, 0)
                    and _g(d, 3) > _g(d, 1)
                    and 190 < _g(f, 2) < 204):
                return _g(f, 2)
            if (_index in (1, 2) and uk3 == 3
                    and 130 < _g(f, 1) < 180):
                return _g(f, 1) / 2
            if (_index == 2 and _g(d, 2) - _g(d, 1) > 18
                    and uk3 == 3):
                if queue_query3(f3, d3, h3, ref_length, 0, _g(f, 2) / 3,
                                _g(f, 2), 0):
                    return _g(f, 2) / 3
                else:
                    return _g(f, 2)
            if (uk3 == 3 and index1 == 2
                    and 280 < _g(f, 2) < 310):
                if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 2) / 2,
                                _g(f, 2), 0):
                    return _g(f, 2) / 2
            if index1 == 1 and uk3 == 4:
                flag = queue_query2(f3, d3, h3, ref_length, 0,
                                    _g(f, 1) / 2, _g(f, 1), 0)
                if (not flag and _g(d, 1) - _g(d, 0) < 2
                        and abs(_g(f, 0) * 2 - _g(f, 1)) < 2):
                    return _g(f, 1) / 2
                return _g(f, 1) / 2 if flag else _g(f, 2) / 2
            if ((_g(d, 0) > _g(d, 1) or _g(d, 1) - _g(d, 0) < 3)
                    and (_g(d, 2) - _g(d, 1) > -10 if uk3 == 3 else True)
                    and 100 < _g(f, 0) < 120):
                return _g(f, 1) / 2
            if (186 < _g(f, 0) < 206 and _g(d, 1) > _g(d, 0)
                    and _g(d, 1) > _g(d, 2) and uk3 == 3):
                return _g(f, 1) / 2

    if (uk1 == 2 and uk2 == 4 and uk3 == 7
            and abs(_g(f, 0) / 2 * 7 - _g(f, 2)) < 10):
        if (_g(d, 0) > _g(d, 1)
                and (_g(d, 1) > _g(d, 2) and _g(d, 1) > _g(d, 3))
                and _g(d, 0) - _g(d, 2) > 20):
            return _g(f, 0)
        if (_g(d, 0) > _g(d, 1)
                and (_g(d, 1) > _g(d, 2) and _g(d, 1) > _g(d, 3))):
            return queue_cut_valid(f, d, length, 1, 0, f2, d2, length2,
                                   f3, d3, ref_length)

    if uk1 == 2 and uk2 == 3 and uk3 == 6:
        _index = _max_index(d, length)
        if 130 < _g(f, 1) < 160:
            return _g(f, 1)
        if (_index == 0
                and (_g(d, 2) > _g(d, 1)
                     or (_g(d, 0) - _g(d, 1) > 14 and _g(h, 1) < 20))
                and 190 < _g(f, 0) < 204):
            return _g(f, 0)
        if _index == 1 and 190 < _g(f, 1) < 204:
            return _g(f, 2) / 2
        if _index == 2 and 190 < _g(f, 2) / 2 < 204:
            return _g(f, 2) / 2
        if (_index == 2 and _g(d, 1) > _g(d, 0)
                and _g(d, 2) - _g(d, 1) > 18
                and 190 < _g(f, 2) < 204):
            return _g(f, 3) / 2
        if (_index == 1 and _g(d, 1) - _g(d, 0) > 18
                and 240 < _g(f, 2) / 2 < 255):
            return _g(f, 2) / 2
        if 130 < _g(f, 0) < 160:
            return _g(f, 0) / 2
        if (_index == 2 and vk3 == 3
                and 100 < _g(f, 2) / 2 < 120):
            return _g(f, 2) / 2
        if 65 < _g(f, 0) < 75:
            return _g(f, 0)
        if (_g(d, 0) - _g(d, 1) > 24 and _g(d, 2) > _g(d, 1)
                and _g(f, 0) > 220):
            return _g(f, 0)
        if (_g(d, 0) - _g(d, 1) > 12 and _g(f, 0) > 220
                and light > 0.98):
            return _g(f, 0)
        if (_index == 1 and _g(d, 1) - _g(d, 0) > 8 and _g(f, 1) > 300
                and _g(h, 0) < 15 and light > 0.98
                and ref_length < 6):
            return _g(f, 1)
        if _index == 0:
            return _g(f, 0) / uk1

    if uk1 == 3 and uk2 == 4 and uk3 == 6 and vk3 == 9:
        if ref_length > 9 and _g(f, 0) > 800:
            fre = _g(f, 0) / uk1
        elif 100 < _g(f, 0) < 120:
            fre = _g(f, 2) / 2
        elif (index1 == 0 and _g(d, 2) > _g(d, 1)
              and 240 < _g(f, 0) < 255):
            fre = _g(f, 2) / 2
        return fre

    if (uk1 == 6 and uk2 == 9 and vk1 == 4 and vk2 == 5 and vk3 == 8
            and index1 == 1 and 190 < _g(f, 1) < 205):
        return _g(f, 3) / 2

    if uk1 == 3 and uk2 == 4 and uk3 == 6 and vk3 in (7, 4):
        if 210 < _g(f, 0) < 270:
            return _g(f, 0) / uk1

    if uk1 == 3 and uk2 == 4 and uk3 == 6:
        if (index1 == 0 and _g(d, 2) > _g(d, 1)
                and 240 < _g(f, 0) < 255):
            return _g(f, 2) / 2
        if (index1 == 0 and _g(d, 1) > _g(d, 2)
                and 195 < _g(f, 0) < 225):
            return _g(f, 0) / uk1
        if (index1 == 2 and 190 < _g(f, 2) < 205 and vk3 != 7):
            return _g(f, 2)

    if uk1 == 6 and uk2 == 7 and uk3 == 9 and vk3 == 12:
        if index1 == 0 and 200 < _g(f, 0) < 240:
            return _g(f, 0) / 2

    if uk1 == 3 and uk2 == 6 and uk3 == 7 and vk3 == 9:
        if (_g(d, 0) > _g(d, 1) and _g(d, 1) > _g(d, 2)
                and (_g(d, 3) > _g(d, 2)
                     or _g(d, 1) - _g(d, 2) > 12)):
            return _g(f, 0)

    if uk1 == 3 and uk2 == 6 and uk3 == 7:
        if (_g(d, 0) - _g(d, 2) > 18
                and 190 < _g(f, 0) < 204):
            return _g(f, 0)
        if (_g(d, 1) - _g(d, 2) > 18 and 200 < _g(f, 1) < 240):
            return _g(f, 1) / 2
        if (_g(d, 0) > _g(d, 1) and _g(d, 1) > _g(d, 2)
                and 100 < _g(f, 0) < 120 and ref_length > 6):
            return _g(f, 1) / 2
        if (_g(d, 0) - _g(d, 1) > 18 and _g(d, 1) > _g(d, 2)
                and _g(d, 1) > _g(d, 3) and _g(f, 0) > 220
                and ref_length < 5):
            return _g(f, 0)
        if (_g(d, 0) - _g(d, 2) > 18 and _g(d, 1) - _g(d, 2) > 10
                and _g(d, 1) - _g(d, 3) > 10 and _g(f, 0) > 220
                and light > 0.98 and ref_length < 5):
            return _g(f, 0)
        if (_g(d, 0) - _g(d, 2) > 20 and _g(d, 1) - _g(d, 2) > 18
                and _g(f, 0) > 300 and light > 0.98
                and ref_length < 6):
            return _g(f, 0)
        if (_g(d, 0) > _g(d, 1) and _g(d, 1) - _g(d, 2) > 20):
            return _g(f, 1) / 2
        if (_g(d, 0) > _g(d, 1) and _g(d, 1) > _g(d, 2)
                and _g(d, 1) > _g(d, 3)):
            return _g(f, 0) / uk1

    if uk1 == 3 and uk2 == 6 and uk3 == 7:
        if (_g(d, 0) - _g(d, 2) > 18
                and 190 < _g(f, 0) < 204):
            return _g(f, 0)
        if (ref_length < 5 and _g(d, 0) > _g(d, 1)
                and _g(d, 0) > _g(d, 2)):
            return _g(f, 0) / uk1
        if ((vk3 == 9 or 300 < _g(f, 3) < 360) and index1 == 1
                and 200 < _g(f, 1) < 240):
            return _g(f, 0)
    elif uk1 == 3 and uk2 == 6 and uk3 == 8:
        if (_g(d, 0) - _g(d, 2) > 18
                and 190 < _g(f, 0) < 204):
            return _g(f, 0)
        if (index1 == 1 and _g(d, 1) - _g(d, 2) > 18
                and 100 < _g(f, 1) / 2 < 120):
            return _g(f, 1) / 2
        if (ref_length < 5 and _g(d, 0) > _g(d, 1)
                and _g(d, 0) > _g(d, 2)
                and _g(d, 1) - _g(d, 2) < 12):
            return _g(f, 0) / uk1

    if uk1 == 3 and uk2 == 5 and uk3 == 6:
        if 300 < _g(f, 0) / 3 < 360 and ref_length > 5:
            return _g(f, 0) / 3

    if (uk1 == 1 and uk2 == 2 and uk3 == 4
            and vk1 == 1 and vk2 == 2 and vk3 == 3):
        if (_g(d, 1) > _g(d, 2) and _g(d, 2) > _g(d, 3)
                and _g(d, 3) > _g(d, 0)
                and 50 < _g(f, 0) < 60):
            return _g(f, 2) / 2
        elif _g(f, 0) < 80:
            fre = _g(f, 0)
            if _g(f, 0) < 60:
                fre = _g(f, 2) / 2
            return fre
        else:
            if _g(d, 0) - _g(d, 1) > 15:
                return _g(f, 0)
        if index1 == 1 and 75 < _g(f, 0) < 90:
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(f, index1) / 2, _g(f, index1), 1):
                return _g(f, index1) / 2
        if index1 == 1 and 240 < _g(f, 1) < 255:
            return _g(f, 2) / 2
        valid_out[0] = 1  # *valid=1 (_queue.c:3352)
        return 0.0

    if (uk1 == 1 and uk2 == 3 and uk3 == 6
            and vk1 == 1 and vk2 == 2 and vk3 == 3):
        _index = _max_index([_g(d, j) for j in range(1, max(length, 2))],
                            length - 1)
        if _g(d, 0) - _g(d, _index + 1) > 10:
            return _g(f, 0)

    if uk1 == 2 and uk2 == 3 and uk3 == 4:
        if 150 < _g(f, 1) < 180:
            if ((abs(_g(d, 0) - _g(d, 1)) < 10
                 or abs(_g(d, 2) - _g(d, 1)) < 10)
                    and abs(_g(d, 0) - _g(d, 2)) < 15
                    and ((_g(d, 1) - _g(d, 3) > 2 and _g(h, 1) > 15)
                         or abs(_g(f2, 0) * 2 - _g(f, 0)) < 5
                         or (_g(d, 1) > _g(d, 3)
                             and abs(_g(d, 0) - _g(d, 1)) < 6))):
                return _g(f, 0) / 2
            if ((abs(_g(d, 0) - _g(d, 1)) < 10
                 or abs(_g(d, 2) - _g(d, 1)) < 10)
                    and abs(_g(d, 0) - _g(d, 2)) < 15
                    and _g(d, 0) > _g(d, 1) and _g(d, 2) > _g(d, 1)
                    and _g(d, 1) - _g(d, 3) > 3):
                return _g(f, 0) / 2
            if queue_query(f3, d3, h3, ref_length, _g(f, 0) / 2):
                return _g(f, 0) / 2
            else:
                return _g(f, 0)
        elif 200 < _g(f, 0) < 240:
            return _g(f, 0) / uk1
        if (index1 == 2 and _g(d, 0) > _g(d, 1)
                and 75 < _g(f, 0) < 90):
            return _g(f, 2) / 2
        if (index1 in (0, 1) and _g(d, index1) > _g(d, 2)
                and _g(d, index1) > _g(d, 3)
                and 150 < _g(f, 0) < 180):
            return _g(f, 0) / 2
    elif vk1 == 2 and vk2 == 3:
        _index = _max_index(d, length)
        if (_index == 1 and _g(d, 0) - _g(d, 2) < 3
                and 120 < _g(f, 1) < 180):
            return _g(f, 1) / 2
        if (uk2 == 4 and _g(d, 1) - _g(d, 0) > 18
                and 120 < _g(f, 1) < 180):
            return _g(f, 1) / 2
        if (_index in (1, 2) and 190 < _g(f, 1) / 2 < 204):
            return _g(f, 1) / 2

    if index1 == 1:
        _index = _max_index(d, length)
        _, ts1, ts2, tk1, tk2, tk3 = queue_fre3(
            _g(f, 1), _g(f, 2), _g(f, 3))
        _, k1, k2 = queue_fre2(_g(f, 1), _g(f, 2))
        if ((tk1 == 1 or k1 == 1) and _g(d, 1) > _g(d, 0)
                and 190 < _g(f, 1) < 204):
            if abs(_g(f, 0) * 2 - _g(f, 1)) < 4:
                return queue_cut_valid(
                    [_g(f, j) for j in range(1, max(length, 1))],
                    [_g(d, j) for j in range(1, max(length, 1))],
                    length - 1, 0, 1, f2, d2, length2, f3, d3, ref_length)
            else:
                if _g(d, 1) > _g(d, 2) and _g(d, 1) > _g(d, 3):
                    return _g(f, 1)
        if tk1 == 2 and tk2 == 3 and tk3 == 4:
            if (190 < _g(f, 1) < 204 and _index == 1
                    and _g(d, 3) - _g(d, 2) < 6 and _g(h, 2) > 18):
                return _g(f, 1) / 2
        if tk1 == 2 and tk2 == 3 and tk3 == 4:
            if 210 < _g(f, 1) < 230:
                return _g(f, 1) / 2
        if (k1 == 3 and k2 == 4 and 195 < _g(f, 1) < 225
                and abs(_g(f, 1) / 3 * 4 - _g(f, 2)) < 4):
            if (index1 == 1 and _g(d, 1) - _g(d, 2) > 24
                    and 95 < _g(f, 0) < 103):
                return _g(f, 1)
            return _g(f, 1) / k1
        if tk1 == 3 and tk2 == 4 and tk3 == 6:
            if (_g(d, 2) > _g(d, 0) and _g(d, 2) > _g(d, 1)
                    and _g(d, 3) > _g(d, 0) and _g(d, 3) > _g(d, 1)
                    and 150 < _g(f, 1) < 180):
                return _g(f, 1) / tk1

    if (uk1 == 2 and uk2 == 3 and uk3 == 4
            and vk1 == 3 and vk2 == 4 and vk3 == 6):
        _index = _max_index(d, length)
        if ref_length > 6:
            if (_index == 3 and 280 < _g(f, 2) < 310
                    and _g(d, 0) - _g(d, 1) > 12
                    and _g(d, 2) - _g(d, 1) > 12):
                return _g(f, 2) / 2
            # C computes maxIndex(dbArr2+4) here but never uses it
            if (280 < _g(f, 3) < 310 and 280 < _g(f2, 3) < 310
                    and _g(d, 3) > _g(d, 2)):
                if _index == 1:
                    return _g(f, 3) / 2
                _fre = 0.0
                if 420 < _g(f2, 4) < 465:
                    _fre = _g(f2, 4)
                elif 420 < _g(f2, 5) < 465:
                    _fre = _g(f2, 5)
                if _fre:
                    _, k1, k2 = queue_fre2(_g(f, 3), _fre)
                    if k1 == 2 and k2 == 3:
                        return _g(f, 3) / 2
        if (_g(d, 1) - _g(d, 0) > 12 and _g(d, 1) - _g(d, 2) > 12
                and _g(d, 3) - _g(d, 0) > 12
                and _g(d, 3) - _g(d, 2) > 12):
            return _g(f, 3) / 2
        if (_index == 3
                or (_index == 0 and _g(d, 0) - _g(d, 3) < 2)):
            fre = _g(f, 0) / uk1
            if 60 < fre < 80:
                return fre
        else:
            if _index <= 1 and abs(_g(d, 0) - _g(d, 1)) < 4:
                return _g(f, 0) / 2
        if (_g(d, 0) > _g(d, 2) and _g(d, 0) > _g(d, 3)
                and _g(d, 1) > _g(d, 2) and _g(d, 1) > _g(d, 3)):
            if (abs(_g(f, 0) / 2 * 3 - _g(f, 1)) < 4
                    and 210 < _g(f, 0) < 230):
                return _g(f, 0) / 2
        if (not index1 and 150 < _g(f, 0) < 170
                and _g(d, 1) > _g(d, 2)):
            return _g(f, 0) / 2
        if (index1 == 2 and 150 < _g(f, 2) < 170
                and _g(d, 0) > _g(d, 1)
                and _g(d, 2) - _g(d, 1) > 15):
            return _g(f, 2) / 2
        if (index1 == 3 and 150 < _g(f, 2) < 170
                and _g(d, 2) > _g(d, 0) and _g(d, 0) > _g(d, 1)):
            return _g(f, 2) / 2
        if (_g(d, 0) - _g(d, 1) > 18
                and 190 < _g(f, 0) < 204):
            return _g(f, 0)
        if (index1 == 3 and 230 < _g(f, index1) < 260
                and _g(d, 2) > _g(d, 0) and _g(d, 2) > _g(d, 1)):
            return _g(f, 2) / 2
        valid_out[0] = 1  # *valid=1 (_queue.c:3689)
        return 0.0

    if (uk1 == 1 and uk2 == 2 and uk3 == 3
            and vk1 == 2 and vk2 == 3 and vk3 == 7):
        if (index1 == 1 and _g(d, 0) > _g(d, 2)
                and _g(d, 0) and _g(d, 3)):  # C float truthiness
            for i in range(ref_length):
                if abs(_g(f, 3) - _g(f3, i)) < 2:
                    return _g(f, 1) / 2

    if uk1 == 1 and uk2 == 2 and uk3 in (3, 4):
        if index1 == 1 and 60 < _g(f, 0) < 85:
            return _g(f, 1) / 2
        if (uk3 == 3 and 190 < _g(f, 0) < 204
                and _g(d, 1) - _g(d, 0) < 3):
            return _g(f, 0)
        if (not index1 and uk3 == 3
                and 200 < _g(f, 1) < 240):
            return _g(f, 1) / 2
        if (150 < _g(f, index1) < 170 and ref_length > 5):
            for i in range(ref_length - 2):
                if _g(f3, i) > _g(f, index1):
                    _fre, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
                        _g(f3, i), _g(f3, i + 1), _g(f3, i + 2))
                    if (ws1 == 1 and ws2 == 1
                            and _g(f, index1) > _fre):
                        _, k1, k2 = queue_fre2(_fre, _g(f, index1))
                        if k1 == 1 and k2 == 2:
                            return _g(f, index1) / 2
        if (uk3 == 3 and index1 == 2
                and 280 < _g(f, 2) < 310):
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 2) / 2,
                            _g(f, 2), 0):
                return _g(f, 2) / 2
        if (190 < _g(f, 1) < 204 and _g(d, 0) - _g(d, 1) < 6
                and ref_length > 5):
            return queue_cut_valid(
                [_g(f, j) for j in range(1, max(length, 1))],
                [_g(d, j) for j in range(1, max(length, 1))],
                length - 1, 0, 1, f2, d2, length2, f3, d3, ref_length)
        if (50 < _g(f, 0) < 60 and _g(d, 1) > _g(d, 2)
                and _g(d, 2) - _g(d, 0) > 12):
            if queue_query(f3, d3, h3, ref_length, _g(f, 0)):
                fre = _g(f, 1) / 2
            else:
                fre = _g(f, 2) / 2
        if (_g(d, 0) > _g(d, 1) and _g(d, 1) > _g(d, 2)
                and _g(d, 1) > _g(d, 3) and ref_length > 5):
            fre = queue_cut_valid(f, d, length, 0, 0, f2, d2, length2,
                                  f3, d3, ref_length)
            _, k1, k2 = queue_fre2(fre, _g(f, 0))
            if k1 == 1 and k1 == k2:
                fre = _g(f, 1) / 2
            return fre

    if uk1 == 1 and uk2 == 3 and uk3 == 4 and vk3 == 6:
        _index = _max_index(d, length)
        if _index == 3:
            fre = _g(f, 0) / uk1
            if 190 < _g(f, 3) < 205:
                return _g(f, 3)
            return fre
        if not _index and 105 < _g(f, 1) / 3 < 115:
            return _g(f, 1) / 3
    elif ((uk1 == 1 and uk2 == 4 and uk3 == 6)
          or (uk1 == 3 and uk2 == 4 and uk3 == 6)):
        _index = _max_index(d, length)
        if (_index == 2 and _g(d, 1) > _g(d, 0)
                and _g(d, 1) > _g(d, 3)):
            if (190 < _g(f, 2) < 204
                    and _g(d, 2) - _g(d, 1) > 15):
                return _g(f, 2)
            if 190 < _g(f, 1) / 2 < 204:
                return _g(f, 1) / 2
            fre = _g(f, 0) / uk1
            if uk1 == 3 and fre < 65:
                fre = _g(f, 1) / 2
            return fre

    if uk1 == 1 and uk2 == 4 and uk3 == 5 and vk3 == 7:
        if _max_index(d, length) == 2:
            return _g(f, 0)
    elif uk1 == 2 and uk2 == 4 and uk3 == 5 and vk3 == 6:
        _index = _max_index(d, length)
        if ((_index == 3
             or (_index == 0 and _g(d, 0) - _g(d, 3) < 2))
                and 120 < _g(f, 0) < 160):
            return _g(f, 0) / 2
        if 200 < _g(f, 0) < 240:
            return _g(f, 0) / 2

    if not uk1:
        if (_g(d, 0) > _g(d, 2) and _g(d, 2) > _g(d, 1)
                and _g(d, 2) > _g(d, 3)):
            _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(f, 0), _g(f, 2), _g(f, 3))
            if uk1:
                if uk1 == 1 and 105 < _g(f, 2) / uk2 < 115:
                    return _g(f, 0) / uk1
            if 210 < _g(f, 2) < 230:
                _fre, k1, k2 = queue_fre2(_g(f, 2), _g(f, 3))
                if k1 == 2 and k2 == 3:
                    return _g(f, 2) / 2
        if (_g(d, 0) > _g(d, 1) and _g(d, 1) > _g(d, 2)
                and _g(d, 1) > _g(d, 3)):
            _fre, k1, k2 = queue_fre2(_g(f, 0), _g(f, 2))
            if k1 == 1:
                if uk2 and 105 < _g(f, 2) / uk2 < 115:
                    return _fre
        if (_g(d, 0) > _g(d, 2) and _g(d, 1) > _g(d, 2)
                and _g(d, 3) > _g(d, 2)):
            _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(f, 0), _g(f, 1), _g(f, 3))
            if uk1 == 1 and 210 < _g(f, 1) < 230:
                return _g(f, 0) / uk1
    else:
        if (_g(d, 0) > _g(d, 2) and _g(d, 0) > _g(d, 3)
                and _g(d, 1) > _g(d, 2) and _g(d, 1) > _g(d, 3)):
            if uk1 == 1 and uk2 == 2 and 210 < _g(f, 1) < 230:
                return _g(f, 1) / 2
        if (_g(d, 0) > _g(d, 2) and _g(d, 1) > _g(d, 2)
                and _g(d, 3) > _g(d, 2)):
            # C overwrites the function-level uk vars here; later rules
            # (e.g. the uk==(2,5,6) ladder below) see the new values
            _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(f, 0), _g(f, 1), _g(f, 3))
            if uk1 == 1 and uk2 == 2 and 210 < _g(f, 1) < 230:
                return _g(f, 0)

    if vk1 == 1 and vk2 == 2 and vk3 == 4 and index1 == 3:
        if 220 < _g(f, 1) < 360:
            return _g(f, 2) / 2

    if 154 < _g(f, index1) < 180 and ref_length > 3:
        if index1 == 0 and uk1 == 2 and uk2 == 5 and uk3 == 6:
            return _g(f, index1) / 2
        if index1 < 2:
            _, k1, k2 = queue_fre2(_g(f, index1), _g(f, index1 + 1))
            if k1 == 2 and k2 == 3:
                return _g(f, index1) / 2
            else:
                if abs(_g(f, index1) / 2
                       - _g(f, index1 + 1) / 3) < 5:
                    return _g(f, index1) / 2
        flag = 1
        if index1 == 1 and _g(d, index1) - _g(d, index1 + 1) > 20:
            _, k1, k2 = queue_fre2(_g(f, index1), _g(f, index1 + 2))
            if k1 == 1 and k2 == 2:
                flag = 0
        if flag:
            _arr_cut(f3, ref_length, _g(f, index1) * 4 + 10)
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(f, index1) / 2, _g(f, index1), 1):
                return _g(f, index1) / 2

    if 150 < _g(f, 0) < 180 and ref_length > 3:
        _, us1, us2, uk1, uk2, uk3 = queue_fre3(
            _g(f, 0), _g(f, 1), _g(f, 2))
        if uk1 == 2 and uk2 == 3:
            return _g(f, 0) / 2
        elif uk1 == 1:
            if queue_query2(f3, d3, h3, ref_length, 0, _g(f, 0) / 2,
                            _g(f, 0), 1):
                return _g(f, 0) / 2
        if (_g(d, 0) > _g(d, 2) and _g(d, 0) > _g(d, 3)
                and abs(_g(f, 0) / 2 * 7 - _g(f, 1)) < 4):
            return _g(f, 0) / 2

    if (uk1 == 1 and uk2 == 2 and uk3 == 3 and vk3 == 6
            and index1 == 2 and 315 < _g(f, index1) < 345):
        if queue_four(f3, d3, h3, ref_length, _g(f, index1)):
            if queue_count(f3, d3, h3, ref_length, 0,
                           _g(f, index1) * 4 + 20, _g(f, index1), 1):
                return _g(f, index1)

    # --- from here the C sorts the caller's arrays IN PLACE ------------
    # (tune_track reads the rows after pitch(), so the mutations are part
    # of the observable behavior; cf/cd/ch/ci alias the inputs when they
    # are mutable lists)
    n = max(length, 0)
    _mut = (isinstance(f, list) and isinstance(d, list)
            and isinstance(h, list) and isinstance(index_arr, list)
            and len(f) >= n and len(d) >= n and len(h) >= n
            and len(index_arr) >= n)
    # The C's buffers are calloc'd wider than the logical length, and the
    # two fixed-count sorts below ("fre asc 2"/"fre asc 3") run UNclamped:
    # at length<3 they drag a zero from past the end into the logical view
    # and push a real value out past it (where later reads still see it).
    # Model that with a working region of max(n, 3) slots; only the first
    # n are mirrored back to the caller (the C caller's visible row).
    ext = max(n, 3)
    cf = [_g(f, j) for j in range(ext)]
    cd = [_g(d, j) for j in range(ext)]
    ch = [_g(h, j) for j in range(ext)]
    ci = [index_arr[j] if j < len(index_arr) else 0 for j in range(ext)]

    def _sort_view(key_arr, count, asc):
        # __vcorrsort1: selection sort over the first `count` entries of
        # key_arr carrying all four arrays; entries past `count` hold
        # their (possibly displaced) values
        idx = list(range(max(n, count)))
        for a in range(count):
            for b in range(a + 1, count):
                if ((key_arr[idx[a]] > key_arr[idx[b]]) if asc
                        else (key_arr[idx[a]] < key_arr[idx[b]])):
                    idx[a], idx[b] = idx[b], idx[a]
        for arrs in (cf, cd, ch, ci):
            tmp = [arrs[j] for j in idx]
            arrs[:len(tmp)] = tmp
        if _mut:
            f[:n] = cf[:n]
            d[:n] = cd[:n]
            h[:n] = ch[:n]
            index_arr[:n] = ci[:n]

    _sort_view(cd, n, asc=False)
    _sort_view(cf, 2, asc=True)
    _fre, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 1))
    if (k1 == 2 and k2 == 3
            and abs(_g(cf, 0) / 2 * 3 - _g(cf, 1)) < 4):
        if 210 < _g(cf, 0) < 230:
            if (_g(cd, 1) - _g(cd, 0) > 6 and light > 0.98
                    and _g(ch, 0) < 15 and ref_length < 6):
                return _g(cf, 1)
            elif (_g(cd, 1) - _g(cd, 0) > 12 and _g(ch, 0) < 8
                  and ref_length <= 3):
                return _g(cf, 1)
            else:
                return _fre
        elif (140 < _g(cf, 0) < 180
              and abs(_g(cd, 0) - _g(cd, 1)) < 12):
            return _fre
    if (k1 == 1 and k2 == 2
            and abs(_g(cf, 0) * 2 - _g(cf, 1)) < 4):
        if 130 < _g(cf, 0) < 160:
            return _g(cf, 1) / 2
        elif 60 < _g(cf, 0) < 85:
            return _g(cf, 1) / 2
        elif 190 < _g(cf, 0) < 204:
            return _g(cf, 0)

    _sort_view(cd, n, asc=False)
    _sort_view(cf, 3, asc=True)
    _fre, us1, us2, uk1, uk2, uk3 = queue_fre3(
        _g(cf, 0), _g(cf, 1), _g(cf, 2))

    if not uk1:
        _fre2_, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 2))
        if (k1 == 1 and k2 == 3 and abs(_g(cf, 0) * 3 - _g(cf, 2)) < 4
                and 100 < _g(cf, 0) < 200):
            if abs(_g(cf, 0) * 2 - _g(cf, 1)) < 10:
                return _fre2_

    if uk1 == 1 and uk2 == 3 and uk3 == 4:
        if 100 < _g(cf, 0) < 120:
            return _g(cf, 1) / 3

    if us1 == 1 and us1 == us2:
        if (abs(_fre * uk2 - _g(cf, 1)) < 5
                and abs(_fre * uk3 - _g(cf, 2)) < 5):
            fre = _fre
            index1 = _max_index(cd, min(3, n))
            if index1 == 0:
                if (uk1 == 2 and 2 * uk1 == uk3
                        and length2 >= 4):
                    _, vs1, vs2, vk1, vk2, vk3 = queue_fre3(
                        _g(f2, 1), _g(f2, 2), _g(f2, 3))
                    if vk1 == 3 and vk2 == 4 and vk3 in (5, 7):
                        return fre
                if (_g(cd, 0) - _g(cd, 1) > 20
                        and _g(cd, 2) - _g(cd, 1) > 10
                        and _g(cf, 0) > 220):
                    return _g(cf, 2) / 2
                if 2 * uk1 == uk3 and ref_length > 5:
                    valid_out[0] = 3  # *valid=3 (_queue.c:4262)
                    return 0.0
            if uk1 == 4 and uk3 == 6 and ref_length > 5:
                valid_out[0] = 3  # *valid=3 (_queue.c:4272)
                return 0.0
    else:
        if uk1 == 2 and uk2 == 3 and uk3 == 6:
            if (_g(cd, 1) > _g(cd, 2) and _g(cd, 2) > _g(cd, 0)
                    and _g(cd, 0) > _g(cd, 3)
                    and 130 < _g(cf, 0) < 150):
                return _g(cf, 0) / uk1
        if uk1 == 2 and uk2 == 3 and uk3 == 6 and ref_length > 5:
            if _max_index(cd, n) == 1:
                if _g(cd, 1) > _g(cd, 2) and _g(cd, 2) > _g(cd, 0):
                    valid_out[0] = 1  # *valid=1 (_queue.c:4302)
                    return 0.0

    if not fre and ref_length < 5:
        if vk1 == 2 and vk2 == 3 and vk3 == 6:
            if _max_index(cd, n) == 2:
                if (_g(cd, 2) - _g(cd, 1) > 15
                        and _g(cd, 1) > _g(cd, 0)):
                    fre = _g(cf, 0)
        elif not vk1 and not uk1:
            _index = _max_index(cd, n)
            if (_index == 1 and _g(cd, 1) - _g(cd, 0) > 12
                    and _g(cd, 1) - _g(cd, 2) > 20
                    and _g(cd, 1) - _g(cd, 3) > 20):
                _, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 1))
                # C divides by k1 unguarded: k1==0 -> inf -> |inf|>5 true
                pred = (_g(cf, 0) / k1 * k2 - _g(cf, 1)) if k1 \
                    else float("inf")
                if abs(pred) > 5 and 190 < _g(cf, 1) < 200:
                    return _g(cf, 1)
            if _index == 1:
                if (_g(cd, 1) - _g(cd, 0) > 15
                        and _g(cd, 1) - _g(cd, 2) > 15
                        and _g(cd, 1) - _g(cd, 3) > 15):
                    _, k1, k2 = queue_fre2(_g(cf, 1), _g(cf, 2))
                    if k1 == 3 and k2 == 4:
                        if _g(cd, 1) - _g(cd, 2) > 30:
                            return _g(cf, 1)
                        return _g(cf, 1) / 3

    if not fre:
        # dB desc then FULL fre asc (restores ascending order in place)
        _sort_view(cd, n, asc=False)
        _sort_view(cf, n, asc=True)
        _index = _max_index(cd, n)
        _, us1, us2, uk1, uk2, uk3 = queue_fre3(
            _g(cf, 0), _g(cf, 1), _g(cf, 2))

        if _index and _g(cf, _index) > 520:
            _fre, k1, k2 = queue_fre2(_g(cf, _index - 1), _g(cf, _index))
            if (_index >= 2
                    and 140 < _g(cf, _index - 2) < 155):  # 12n,13n
                _, tk1, tk2 = queue_fre2(_g(cf, _index - 2),
                                         _g(cf, _index - 1))
                if tk1 == 1 and tk2 in (2, 3):
                    if queue_query2(f3, d3, h3, ref_length, 0,
                                    _g(cf, index1 - 2),
                                    _g(cf, index1 - 2) * 2, 0):
                        return _g(cf, index1 - 1) / tk2
            elif 280 < _fre < 310:
                if queue_query2(f3, d3, h3, ref_length, 0, _fre / 2,
                                _fre, 0):
                    return _fre / 2
            if k1 == 1:
                return _fre

        if index1 == 3 and 240 < _g(cf, 3) / 2 < 255:
            _, tk1, tk2 = queue_fre2(_g(cf, index1 - 1), _g(cf, index1))
            if (tk1 == 1 and tk2 == 2
                    and abs(_g(cf, index1 - 1) * tk2
                            - _g(cf, index1)) < 5):
                return _g(cf, index1) / 2

        if _index < 3:
            _fre, k1, k2 = queue_fre2(_g(cf, _index), _g(cf, _index + 1))
            if k1 == 1 and 190 < _g(cf, _index) < 204:
                return _g(cf, _index)
            elif (_index == 1 and 190 < _g(cf, _index) < 204
                  and _g(cd, 1) - _g(cd, 2) > 20
                  and _g(cd, 3) > _g(cd, 2)):
                _fre, k1, k2 = queue_fre2(_g(cf, 1), _g(cf, 3))
                if k1 == 1:
                    return _g(cf, 3) / k2 if k2 < 5 else _g(cf, 1)

        _fre, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 1))
        if _index == 1:
            if (k1 == 1 and k2 == 2
                    and abs(_g(cf, 0) * 2 - _g(cf, 1)) < 5
                    and 70 < _g(cf, 0) < 90
                    and _g(cd, 0) - _g(cd, 2) < 3
                    and _g(cd, 0) - _g(cd, 3) < 3):
                return _fre

        if _index == 1:
            if _g(cd, 1) - _g(cd, 0) > 15:
                _, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
                    _g(cf, 1), _g(cf, 2), _g(cf, 3))
                if ((wk1 == 3 and wk2 == 4 and wk3 == 6)
                        or (wk1 == 4 and wk2 == 5 and wk3 == 8)
                        or (wk1 == 5 and wk2 == 6 and wk3 == 10)):
                    return _g(cf, 1)
            if 130 < _g(cf, 1) < 160:
                if (_g(cd, 1) - _g(cd, 2) > 20
                        and _g(cd, 1) - _g(cd, 3) > 20):
                    return _g(cf, 1)
                else:
                    _fre, k1, k2 = queue_fre2(_g(cf, 1), _g(cf, 3))
                    if k1 == 1:
                        return _g(cf, 1)

        if (not _index and uk1 == 3 and uk2 in (4, 5) and uk3 == 6):
            if _g(cd, 0) > _g(cd, 1) and _g(cd, 2) > _g(cd, 1):
                _fre, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
                    _g(cf, 0), _g(cf, 2), _g(cf, 3))
                if wk1 == 1 and 210 < _g(cf, 2) < 230:
                    return _fre
        else:
            if _index:
                if (_g(cd, 0) > _g(cd, 2) and _g(cd, 0) > _g(cd, 3)
                        and _g(cd, 1) > _g(cd, 2)
                        and _g(cd, 1) > _g(cd, 3)):
                    _fre, k1, k2 = queue_fre2(_g(cf, _index - 1),
                                              _g(cf, _index))
                    if (k1 == 2 and k2 == 3
                            and 210 < _g(cf, _index - 1) < 230):
                        if (index1 == 1 and ref_length <= 3
                                and _g(ch, 0) < 8
                                and _g(cd, 1) - _g(cd, 0) > 12):
                            return 0.0
                        return _fre

        _fre, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 1))
        if (k1 == 1 and k2 == 2 and abs(_g(cf, 0) * 2 - _g(cf, 1)) < 5
                and _g(cf, 0) < 95 and _g(cd, 1) - _g(cd, 0) < 12
                and _g(cd, 0) > _g(cd, 2) and _g(cd, 0) > _g(cd, 3)):
            return _fre
        elif (index1 and index1 < 3
              and 150 < _g(cf, index1) < 170):
            _fre, k1, k2 = queue_fre2(_g(cf, index1), _g(cf, index1 + 1))
            if k1 == 2 and k2 == 3:
                return _g(cf, index1) / 2
            if (index1 == 1 and _g(cd, 0) > _g(cd, 2)
                    and _g(cd, 0) > _g(cd, 3)
                    and abs(_g(cf, 0) - _g(cf, 1) / 2) < 5):
                return _g(cf, 1) / 2
            if (index1 == 1 and _g(cd, 0) > _g(cd, 2)
                    and _g(cd, 0) > _g(cd, 3)):
                for i in range(ref_length - 2):
                    if _g(f3, i) > _g(cf, index1):
                        _fre, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
                            _g(f3, i), _g(f3, i + 1), _g(f3, i + 2))
                        if (ws1 == 1 and ws2 == 1
                                and _g(cf, index1) > _fre):
                            _, k1, k2 = queue_fre2(_fre, _g(cf, 1))
                            if k1 == 1 and k2 == 2:
                                return _g(cf, 1) / 2

    if not fre and 105 < _g(cf, 0) < 115:
        if (index1 == 2 and _g(cd, 0) > _g(cd, 1)
                and _g(cd, 3) > _g(cd, 1)):
            _, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
                _g(cf, 0), _g(cf, 2), _g(cf, 3))
            if (wk1 == 1 and wk2 == 2
                    and abs(_g(cf, 0) * 2 - _g(cf, 2)) < 5):
                return _g(cf, 2) / 2
        if (index1 == 1 and _g(cd, 0) > _g(cd, 2)
                and _g(cd, 0) > _g(cd, 3)):
            _, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 1))
            if (k1 == 1 and k2 == 2
                    and abs(_g(cf, 0) * 2 - _g(cf, 1)) < 5):
                return _g(cf, 1) / 2
        if (_g(cd, 0) - _g(cd, 3) > 12
                and _g(cd, 2) - _g(cd, 3) > 12):
            _, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
                _g(cf, 0), _g(cf, 2), _g(cf, 3))
            if (wk1 == 1 and wk2 == 2 and wk3 == 3
                    and abs(_g(cf, 0) * 2 - _g(cf, 2)) < 4
                    and abs(_g(cf, 0) * 3 - _g(cf, 3)) < 4):
                return _g(cf, 2) / 2
        if (_g(cd, 0) - _g(cd, 2) > 12
                and _g(cd, 2) - _g(cd, 3) > 20):
            _, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 2))
            if (k1 == 1 and k2 == 3
                    and abs(_g(cf, 0) - _g(cf, 2) / 3) < 4):
                return _g(cf, 2) / 3

    if (not fre and 200 < _g(cf, index1) < 240 and index1 < 3
            and ref_length > 10):
        flag = 0
        if index1 == 0 and _g(cd, 0) - _g(cd, 1) > 15:
            flag = 1
        else:
            if (_g(cd, index1) - _g(cd, index1 - 1) > 15
                    and _g(cd, index1) - _g(cd, index1 + 1) > 15):
                flag = 1
        if flag:
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(cf, index1) / 2, _g(cf, index1), 0):
                return _g(cf, index1) / 2
        if (index1 == 1
                and abs(_g(cf, index1) / 2 - _g(cf, 0)) < 5):
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(cf, index1) / 2, _g(cf, index1), 1):
                return _g(cf, index1) / 2
        if (index1 == 2 and _g(cd, 0) > _g(cd, 1)
                and _g(cd, 2) > _g(cd, 1)
                and abs(_g(cf, index1) / 2 - _g(cf, 0)) < 5):
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(cf, index1) / 2, _g(cf, index1), 1):
                return _g(cf, index1) / 2

    if (not fre and (315 < _g(cf, index1) < 345
                     or 105 < _g(cf, index1) < 115)
            and ref_length > 10):
        _, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
            _g(cf, 0), _g(cf, 1), _g(cf, 2))
        if wk1 == 1 and wk2 == 2 and wk3 == 3:
            if queue_query3(f3, d3, h3, ref_length, 0, _g(cf, 2) / 3,
                            _g(cf, 2), 0):
                return _g(cf, 2) / 3
        _, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 1))
        if k1 == 1 and k2 == 3:
            if queue_query3(f3, d3, h3, ref_length, 0, _g(cf, 1) / 3,
                            _g(cf, 1), 0):
                return _g(cf, 1) / 3
        _, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
            _g(cf, 0), _g(cf, 2), _g(cf, 3))
        if wk1 == 1 and wk2 == 2 and wk3 == 3:
            if queue_query3(f3, d3, h3, ref_length, 0, _g(cf, 3) / 3,
                            _g(cf, 3), 0):
                return _g(cf, 3) / 3

    if (not fre and 200 < _g(cf, index1) < 240 and ref_length > 5):
        if index1 == 0:
            _, k1, k2 = queue_fre2(_g(cf, 0), _g(cf, 2))
            if (k1 == 2 and k2 == 3
                    and abs(_g(cf, 0) / 2 * 3 - _g(cf, 2)) < 5):
                return _g(cf, 0) / 2
        if index1 == 1:
            _, ws1, ws2, wk1, wk2, wk3 = queue_fre3(
                _g(cf, 0), _g(cf, 1), _g(cf, 3))
            if (wk1 == 1 and wk2 == 2
                    and abs(_g(cf, 0) * 2 - _g(cf, 1)) < 5
                    and abs(_g(cf, 0) * wk3 - _g(cf, 3)) < wk3 * 3):
                return _g(cf, 1) / 2

    if (not fre and 230 < _g(cf, index1) < 260 and index1 > 1):
        _, k1, k2 = queue_fre2(_g(cf, index1 - 1), _g(cf, index1))
        if ((k1 == 2 and k2 == 3)
                or abs(_g(cf, index1 - 1) / 2
                       - _g(cf, index1) / 3) < 5):
            flag = 0
            if (index1 == 2 and _g(cd, 1) > _g(cd, 0)
                    and _g(cd, 1) > _g(cd, 3)):
                flag = 1
            elif _g(cd, 2) > _g(cd, 0) and _g(cd, 2) > _g(cd, 1):
                _len = ref_length - 1
                for i in range(ref_length):
                    if _g(f3, i) > 1200:
                        _len = i
                if _len > 5:
                    flag = 1
            if flag:
                return _g(cf, index1 - 1) / 2

    if (not fre and _g(cd, 1) > _g(cd, 0) and _g(cd, 2) > _g(cd, 0)
            and _g(cd, 1) > _g(cd, 3) and _g(cd, 2) > _g(cd, 3)):
        _, k1, k2 = queue_fre2(_g(cf, 1), _g(cf, 2))
        if (k1 == 2 and k2 == 3 and 140 < _g(cf, 1) < 180
                and abs(_g(cf, 1) / 2 - _g(cf, 2) / 3) < 3):
            return _g(cf, 1) / 2

    if (not fre and 280 < _g(cf, index1) < 310 and ref_length > 3):
        if index1 == 2:
            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(cf, index1 - 1), _g(cf, index1), _g(cf, index1 + 1))
            if uk1 == 1 and uk2 == 2:
                return _g(cf, index1) / 2
            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(cf, 0), _g(cf, index1), _g(cf, index1 + 1))
            if uk1 == 1 and uk2 == 2 and uk3 == 3:
                return _g(cf, index1) / 2
        elif index1 == 1:
            _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                _g(cf, index1), _g(cf, index1 + 1), _g(cf, index1 + 2))
            if uk1 == 2 and uk2 == 4 and uk3 == 5:
                return _g(cf, index1) / 2
            _index = _max_index(d2, length2) if length2 else 0
            if _index + 2 < length2:
                _, us1, us2, uk1, uk2, uk3 = queue_fre3(
                    _g(f2, _index), _g(f2, _index + 1),
                    _g(f2, _index + 2))
                if ((uk1 == 2 and uk2 == 3)
                        or (uk1 == 2 and uk2 == 4 and uk3 == 5)):
                    return _g(f2, _index) / 2

    if (not fre and index1 == 2 and _g(cd, 1) > _g(cd, 0)
            and _g(cd, 1) > _g(cd, 3)):
        _, k1, k2 = queue_fre2(_g(cf, 1), _g(cf, 2))
        if (k1 == 1 and k2 == 2
                and abs(_g(cf, 1) - _g(cf, 2) / 2) < 8):
            if queue_query2(f3, d3, h3, ref_length, 0,
                            _g(cf, index1) / 2, _g(cf, index1), 1):
                return _g(cf, index1) / 2

    if (not fre and index1 == 2 and _g(cf, 2) / 2 > 230
            and ref_length > 12):
        _, us1, us2, uk1, uk2, uk3 = queue_fre3(
            _g(cf, 1), _g(cf, 2), _g(cf, 3))
        if uk1 == 1 and uk2 == 2 and uk3 == 3:
            return _g(cf, 2) / 2

    if not fre and light > 0.98 and ref_length > 6:
        _fre1 = queue_multi(f3, d3, h3, ref_length, 2, 0, 1, 0)
        if 230 < _fre1 < 255:
            fre = _fre1
        elif 300 < _fre1 < 345:
            fre = _fre1
        if not fre and light > 0.99:
            _fre1 = queue_multi(f3, d3, h3, ref_length, 2, 0, 2, 0)
            if 300 < _fre1 < 345:
                fre = _fre1
        if not fre and 240 < _g(cf, 2) < 255:
            flag, _idx = queue_bear(f3, d3, h3, ref_length, 1500,
                                    _g(cf, 2), 0)
            if flag:
                return _g(cf, 2)

    if not fre and ref_length > 9:
        _fre1 = queue_multi(f3, d3, h3, ref_length, 2, 0, 1, 0)
        if 230 < _fre1 < 255:
            fre = _fre1

    if not fre and 300 < _g(cf, index1) < 360:
        if queue_four(f3, d3, h3, ref_length, _g(cf, index1)):
            if queue_count(f3, d3, h3, ref_length, 0,
                           _g(cf, index1) * 4 + 20, _g(cf, index1), 1):
                fre = _g(cf, index1)

    if (not fre and index1 == 1 and 300 < _g(cf, index1) < 360
            and _g(cf, 3) > 2000 and ref_length > 4):
        _, k1, k2 = queue_fre2(_g(cf, 1), _g(cf, 2))
        if k1 == 1 and k2 == 2:
            _, k1, k2 = queue_fre2(_g(f3, 3), _g(f3, 4))
            dev = (abs(_g(f3, 3) / k1 - _g(cf, 1)) if k1
                   else float("inf"))  # C divides unguarded
            if k1 + 1 == k2 and dev < 10:
                fre = _g(cf, 2) / 2

    return fre
