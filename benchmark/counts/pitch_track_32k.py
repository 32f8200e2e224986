"""The bytes and operations of one ``pitch_track_32k`` call's stages on
(rows, n) recordings, counted from the work and not from the kernels, so
that they read the same whatever computes a stage.

- Bytes: the audio read once (4 B a sample) and the stage's output
  written once (4 B a frame).  Frames, spectra and grids are
  intermediates and are not counted.
- Operations: the transforms alone, each a pruned real transform of
  ``2.5 N log2 L`` a frame: N the transform's length, L the smaller of its
  live input samples and the outputs read, each rounded up to a power of
  two.  NCF and HarmonicRatio: the forward at 2 N of the N-sample frame,
  and the inverse to the lags read.  HPS: the forward at X of the frame.
  PEF: the forward at 2 N of the frame, the forward at X of the 2 N
  log-grid points, and the inverse to the lags read.

The gathers, products, scans and searches are not counted, so each share
of this bound is a lower bound, and no implementation of the same
transforms reads over 100%.  At the cell's 74,976 frames every stage is
bound by its operations.
"""

from __future__ import annotations

import math

from benchmark.reference import common
from benchmark.reference.pitch_track_32k import (Pef, hps_grid, hr_max_lag,
                                                 ncf_lags)


def _pow2_at_least(k: int) -> int:
    return 1 << max(int(k) - 1, 0).bit_length()


def pruned_ops(n: int, live: int, read: int) -> float:
    """``2.5 n log2 L`` of one transform of ``n`` points, L = min(live,
    read), each rounded up to a power of two (at most n)."""
    lg = min(_pow2_at_least(live), _pow2_at_least(read), n)
    return 2.5 * n * math.log2(lg)


def _need(p: dict, rows: int, n: int, per_frame: float):
    frame = 1 << p["radix2_exp"]
    t = common.n_frames(n, frame, p["slide_length"])
    return 4 * rows * (n + t), rows * t * per_frame


def ncf_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of NCF on ``rows`` recordings of ``n``
    samples."""
    p = cfg["plans"]["ncf"]
    frame = 1 << p["radix2_exp"]
    lags = ncf_lags(p)[1] + 1
    return _need(p, rows, n, pruned_ops(2 * frame, frame, 2 * frame)
                 + pruned_ops(2 * frame, 2 * frame, lags))


def hr_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of HarmonicRatio."""
    p = cfg["plans"]["hr"]
    frame = 1 << p["radix2_exp"]
    lags = hr_max_lag(p) + 1
    return _need(p, rows, n, pruned_ops(2 * frame, frame, 2 * frame)
                 + pruned_ops(2 * frame, 2 * frame, lags))


def hps_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of HPS."""
    p = cfg["plans"]["hps"]
    frame = 1 << p["radix2_exp"]
    big, _, hi, harmonics = hps_grid(p)
    return _need(p, rows, n, pruned_ops(big, frame, hi * harmonics + 1))


def pef_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of PEF."""
    p = cfg["plans"]["pef"]
    frame = 1 << p["radix2_exp"]
    g = Pef(p)
    return _need(p, rows, n, pruned_ops(2 * frame, frame, 2 * frame)
                 + pruned_ops(g.xcorr_n, 2 * frame, g.xcorr_n)
                 + pruned_ops(g.xcorr_n, g.xcorr_n, g.max_index + 1))
