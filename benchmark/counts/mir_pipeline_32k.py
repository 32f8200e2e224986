"""The bytes and operations of one ``mir_pipeline_32k`` call's HPSS stage
on (rows, n) recordings: the audio read once, the harmonic and percussive
signals written once (float32); a real forward transform and the two real
inverses at 2.5 n log2 n each a frame.  The medians' comparisons and the
masks are not counted, so a share of this bound is a lower bound."""

from __future__ import annotations

import math

from benchmark.reference import common


def hpss_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of HPSS on ``rows`` recordings of ``n``
    samples."""
    p = cfg["plans"]["hpss"]
    n_fft, slide = 1 << p["radix2_exp"], p["slide_length"]
    t = common.n_frames(n, n_fft, slide)
    out_n = (t - 1) * slide + n_fft
    n_bytes = 4 * (rows * n + 2 * rows * out_n)
    return n_bytes, rows * t * 3 * 2.5 * n_fft * math.log2(n_fft)
