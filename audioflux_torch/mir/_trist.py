"""Tri-state pitch candidate resolution (direct port).

Counterpart of ``audioflux_tpu/mir/_trist.py``: a verbatim copy (pure
numpy, host code).

Reference ``src/classic/trist.c``: given the top spectral-peak frequency
candidates of one frame (corr_arr, dB-descending) the resolver walks an
ordered rule table of harmonic patterns ("123", "1234", "2357", ...) built
on ``util_freTimes`` (midi-tolerant integer frequency ratios) and returns
the implied fundamental. The repeated C blocks are expressed here as one
rule table evaluated in the same order with the same tie semantics.
"""

from __future__ import annotations

import numpy as np

__all__ = ["trist", "fre_times"]


def _fre_to_midi(f):
    return int(round(12 * np.log2(max(f, 1e-12) / 440.0) + 69))


def _midi_to_fre(m):
    return 2.0 ** ((m - 69) / 12.0) * 440.0


def _fre_to_simular_midi(f):
    m1 = _fre_to_midi(f)
    t1 = _midi_to_fre(m1)
    m2 = m1 - 1 if f < t1 else m1 + 1
    t2 = _midi_to_fre(m2)
    det = t1 - t2
    mid = t2 + det / 2
    if abs(f - mid) > abs(det) / 4:
        return 0
    return m2


def _midi_times(m1, m2):
    if m1 >= m2:
        f1, f2, hi = _midi_to_fre(m1), _midi_to_fre(m2), m1
    else:
        f1, f2, hi = _midi_to_fre(m2), _midi_to_fre(m1), m2
    k = int(round(f1 / f2))
    if _fre_to_midi(f2 * k) != hi:
        return 0
    return k


def fre_times(f1, f2):
    """util_freTimes: integer ratio snapped through the midi grid."""
    m1, m2 = _fre_to_midi(f1), _fre_to_midi(f2)
    s1, s2 = _fre_to_simular_midi(f1), _fre_to_simular_midi(f2)
    k = _midi_times(m1, m2)
    if not k:
        if m1 < m2:
            if s1:
                k = _midi_times(s1, m2)
            if not k and s2:
                k = _midi_times(m1, s2)
            if not k and s1 and s2:
                k = _midi_times(s1, s2)
        else:
            if s2:
                k = _midi_times(m1, s2)
            if not k and s1:
                k = _midi_times(s1, m2)
            if not k and s1 and s2:
                k = _midi_times(s1, s2)
    return k


def _eq(a, b):
    return abs(a - b) < 0.1


def trist(corr, db, height, midi1, fre_arr, db2, height2, midi2,
          count1, count2):
    """Returns (flag, fre). Inputs mirror the C signature: corr/db/height
    are dB-descending candidate arrays (zero-padded to >= 6), fre_arr/midi2
    the feature context lists."""
    corr = np.asarray(corr, np.float64)
    db = np.asarray(db, np.float64)
    f = fre_times

    def srt(n):
        return np.sort(corr[:n])

    # --- pattern table: (sort_n, base_fn, [(pos, want)], extra, result_fn)
    # want: int for exact match, 'nz' for any nonzero
    def run_pattern(n, base_fn, checks, result_fn, extra=None):
        a = srt(n)
        base = base_fn(a)
        for pos, want in checks:
            k = f(a[pos], base)
            if want == "nz":
                if not k:
                    return None
            elif k != want:
                return None
        if extra is not None and not extra(a):
            return None
        return result_fn(a)

    b0 = lambda a: a[0]
    b0h = lambda a: a[0] / 2
    b0t = lambda a: a[0] / 3
    b1 = lambda a: a[1]
    b1h = lambda a: a[1] / 2
    r1h = lambda a: a[1] / 2
    r2h = lambda a: a[2] / 2
    r0h = lambda a: a[0] / 2
    r0t = lambda a: a[0] / 3

    c0 = corr[0]
    rules = [
        # 123 / 1234 / 1234nn / 1234n / 1247
        (3, b0, [(1, 2), (2, 3)], r1h, None),
        (4, b0, [(1, 2), (2, 3), (3, 4)], r1h, None),
        (6, b0, [(1, 2), (2, 3), (3, 4), (4, "nz"), (5, "nz")], r1h, None),
        (6, b0, [(1, 2), (2, 3), (3, 4), (4, "nz")], r1h, None),
        (4, b0, [(1, 2), (2, 4), (3, 7)], r1h, None),
        # 1234* family (one interloper)
        (5, b0, [(2, 2), (3, 3), (4, 4)], r2h, lambda a: not _eq(a[1], c0)),
        (5, b0, [(1, 2), (3, 3), (4, 4)], r1h, lambda a: not _eq(a[2], c0)),
        (5, b0, [(1, 2), (2, 3), (4, 4)], r1h, lambda a: not _eq(a[3], c0)),
        (5, b0, [(1, 2), (2, 3), (3, 4)], r1h, lambda a: not _eq(a[4], c0)),
        (5, b1, [(2, 2), (3, 3), (4, 4)], r2h, lambda a: not _eq(a[0], c0)),
        # 123* family
        (4, b0, [(2, 2), (3, 3)], r2h, lambda a: not _eq(a[1], c0)),
        (4, b0, [(1, 2), (3, 3)], r1h, lambda a: not _eq(a[2], c0)),
        (4, b0, [(1, 2), (2, 3)], r1h, lambda a: not _eq(a[3], c0)),
        (4, b1, [(2, 2), (3, 3)], r2h, lambda a: not _eq(a[0], c0)),
        # 1*23nn
        (6, b0, [(2, 2), (3, 3), (4, "nz"), (5, "nz")], r2h,
         lambda a: not _eq(a[1], c0)),
        # 123nn / 123nnn / 123n
        (5, b0, [(1, 2), (2, 3), (3, "nz"), (4, "nz")], r1h, None),
        (6, b0, [(1, 2), (2, 3), (3, "nz"), (4, "nz"), (5, "nz")], r1h, None),
        (4, b0, [(1, 2), (2, 3), (3, "nz")], r1h, None),
    ]

    for n, base_fn, checks, result_fn, extra in rules:
        out = run_pattern(n, base_fn, checks, result_fn, extra)
        if out is not None:
            return 1, float(out)

    # 1? +23 +dB (trist.c:"1? +23!!! +dB")
    a = np.sort(corr[2:4])
    if (f(a[0], corr[0]) == 2 and f(a[1], corr[0]) == 3
            and a[0] > corr[0]
            and round(db[0] - db[1]) >= 10 and round(db[0] - db[2]) >= 10
            and round(db[0] - db[3]) >= 10):
        return 1, float(corr[0])

    # 1 +dB
    if round(abs(db[0])) >= 48 and round(db[0] - db[1]) >= 20:
        return 1, float(corr[0])

    # 12468
    out = run_pattern(5, b0, [(1, 2), (2, 4), (3, 6), (4, 8)], r2h)
    if out is not None:
        return 1, float(out)

    # 1246 +dB (corr-ascending relate sort carrying dBs)
    order = np.argsort(corr[:4], kind="stable")
    a = corr[:4][order]
    d = db[:4][order]
    if f(a[1], a[0]) == 2 and f(a[2], a[0]) == 4 and f(a[3], a[0]) == 6:
        return 1, float(a[1] / 2 if db[0] - d[0] < 6 else a[1])

    rules2 = [
        (5, b0, [(1, 2), (2, 5), (3, "nz"), (4, "nz")], r1h, None),
        (5, b0, [(1, 2), (2, 4), (3, 5), (4, 7)], r1h, None),
        (4, b0h, [(1, 3), (2, 5), (3, 7)], r0h, None),
        (4, b0h, [(1, 3), (2, 6), (3, 7)], r0h, None),
        (4, b0h, [(1, 3), (2, 4), (3, 7)], r0h, None),
        (4, b0h, [(1, 3), (2, 4), (3, 6)], r0h, None),
        (4, b0h, [(1, 3), (2, 7), (3, "nz")], r0h, None),
        (5, b0h, [(1, 3), (2, 7), (3, "nz"), (4, "nz")], r0h, None),
        (5, b0h, [(1, 3), (2, 6), (3, 7), (4, "nz")], r0h, None),
    ]
    for n, base_fn, checks, result_fn, extra in rules2:
        out = run_pattern(n, base_fn, checks, result_fn, extra)
        if out is not None:
            return 1, float(out)

    # 124[5|7|9|11]nn
    a = srt(6)
    ks = [f(a[i], a[0]) for i in range(1, 6)]
    if (ks[0] == 2 and ks[1] == 4 and ks[2] and ks[3] and ks[4]
            and any(k in (5, 7, 9, 11) for k in ks[2:5])):
        return 1, float(a[1] / 2)

    rules3 = [
        (6, b0h, [(1, 3), (2, 4), (3, "nz"), (4, "nz"), (5, "nz")], r0h, None),
        (5, b0h, [(1, 3), (2, 4), (3, "nz"), (4, "nz")], r0h, None),
        # 234* family
        (4, b0h, [(2, 3), (3, 4)], r0h, lambda a: not _eq(a[1], c0)),
        (4, b0h, [(1, 3), (3, 4)], r0h, lambda a: not _eq(a[2], c0)),
        (4, b0h, [(1, 3), (2, 4)], r0h, lambda a: not _eq(a[3], c0)),
        (4, lambda a: a[1] / 2, [(2, 3), (3, 4)], lambda a: a[1] / 2,
         lambda a: not _eq(a[0], c0)),
        (6, b0h, [(1, 4), (2, 5), (3, "nz"), (4, "nz"), (5, "nz")], r0h, None),
        (4, b0h, [(1, 4), (2, 5), (3, "nz")], r0h, None),
        (4, b0h, [(1, 3), (2, 4)], r0h, None),  # 234n (k3 unchecked in C)
        (6, b0h, [(1, 5), (2, 7), (3, "nz"), (4, "nz"), (5, "nz")], r0h, None),
        (6, b0h, [(1, 6), (2, 7), (3, "nz"), (4, "nz"), (5, "nz")], r0h, None),
        (6, b0h, [(1, 7), (2, 9), (3, "nz"), (4, "nz"), (5, "nz")], r0h, None),
        (6, b0h, [(1, 4), (2, 6), (3, 7), (4, "nz"), (5, "nz")], r0h, None),
        (5, b0h, [(1, 3), (2, 4), (3, "nz"), (4, "nz")], r0h, None),
        (4, b0h, [(1, 3), (2, 4), (3, "nz")], r0h, None),
        (4, b0t, [(1, 4), (2, 5), (3, 6)], r0t, None),
        (4, b0t, [(1, 4), (2, 6), (3, 7)], r0t, None),
        (4, b0t, [(1, 5), (2, 6), (3, 7)], r0t, None),
    ]
    for n, base_fn, checks, result_fn, extra in rules3:
        out = run_pattern(n, base_fn, checks, result_fn, extra)
        if out is not None:
            return 1, float(out)

    sub1 = abs(corr[0] - corr[1])
    # 32n
    if corr[0] > corr[1] and abs(db[1] - db[2]) < 6:
        if f(sub1, corr[0]) == 3 and f(sub1, corr[1]) == 2:
            return 1, float(corr[1] / 2)

    # nnn: neighbor feature context
    midi2 = np.asarray(midi2, np.int64)
    fre_arr = np.asarray(fre_arr, np.float64)
    midi = _fre_to_midi(corr[0])
    total = count1 + count2
    hits = np.where(midi2[:total] == midi)[0]
    if len(hits):
        index = int(hits[0])
        if index - 1 >= 0:
            s = abs(fre_arr[index - 1] - corr[0])
            k1, k2, k3 = f(s, corr[0]), f(s, corr[1]), f(s, corr[2])
            if k1 and k2 and k3:
                return 1, float(corr[0] / k1)
        if index + 1 < total:
            s = abs(fre_arr[index + 1] - corr[0])
            k1, k2, k3 = f(s, corr[0]), f(s, corr[1]), f(s, corr[1])
            if k1 and k2 and k3:
                return 1, float(corr[0] / k1)

    # 1nn / 2nn / n2n / 23
    if corr[1] > corr[0] and corr[2] > corr[0]:
        k1, k2 = f(corr[0], corr[1]), f(corr[0], corr[2])
        if k1 and k2:
            return 1, float(corr[1] / k1)
        k1, k2 = f(corr[0] / 2, corr[1]), f(corr[0] / 2, corr[2])
        if k1 and k2:
            return 1, float(corr[0] / 2)
    if corr[0] > corr[1] and corr[2] > corr[1]:
        k1, k2 = f(corr[1] / 2, corr[0]), f(corr[1] / 2, corr[2])
        if k1 and k2:
            return 1, float(corr[1] / 2)
    if f(corr[1], corr[0] / 2) == 3 and corr[0] < corr[1]:
        return 1, float(corr[0] / 2)

    return 0, 0.0
