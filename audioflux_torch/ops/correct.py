"""Spectral peak frequency correction for rect/hann/hamm windows.

Counterpart of ``audioflux_tpu/ops/correct.py`` (reference
``src/dsp/flux_correct.c``): given a local peak (left, cur, right) of the
magnitude spectrum, estimate the fractional bin offset ``det`` and the
corrected amplitude.  The hamm variant runs 8 fixed-point iterations.
All functions are element-wise over tensors of one shape; ``cond``, when
given, is the (bool tensor) pick ``right >= left`` made beforehand, e.g. on
float64 values of which ``cur``, ``left``, ``right`` are the float32
roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.types import WindowType

__all__ = ["correct_rect", "correct_hann", "correct_hamm", "correct_fn"]

_EPS = 1e-10


def _pick(cur, left, right, cond=None):
    if cond is None:
        cond = right >= left
    y1 = torch.where(cond, cur, left)
    y2 = torch.clamp(torch.where(cond, right, cur), min=_EPS)
    return y1, y2


def _amp(cur, det, shape_fn):
    n = torch.where(det >= 0, torch.floor(det), torch.ceil(det))
    s = det - n
    s = torch.where(s.abs() < 1e-8, torch.full_like(s, 1e-8), s)
    c1 = n + s
    c2 = np.pi * c1 / torch.sin(np.pi * c1)
    return shape_fn(cur, c1, c2)


def correct_rect(cur, left, right, cond=None):
    y1, y2 = _pick(cur, left, right, cond)
    v1 = y1 / y2
    det = 1.0 / torch.clamp(1 + v1, min=_EPS)
    det = torch.where(y1 < y2, det - 1.0, det)
    return det, _amp(cur, det, lambda c, c1, c2: c * c2)


def correct_hann(cur, left, right, cond=None):
    y1, y2 = _pick(cur, left, right, cond)
    v1 = y1 / y2
    det = (2.0 - v1) / torch.clamp(1 + v1, min=_EPS)
    det = torch.where(y1 < y2, det - 1.0, det)
    return det, _amp(cur, det,
                     lambda c, c1, c2: c * c2 * (1 - c1 * c1) * 2.0)


def correct_hamm(cur, left, right, cond=None):
    y1, y2 = _pick(cur, left, right, cond)
    c1 = -27.0 / 4.0
    v1 = y1 / y2
    det = -(2.0 - v1) / (1.0 + v1)
    for _ in range(8):
        v2 = (det * det + c1) / ((det + 1.0) ** 2 + c1)
        det = (v1 - 2.0 * v2) / (v1 + v2)
    det = -det
    det = torch.where(y1 < y2, det - 1.0, det)
    return det, _amp(cur, det,
                     lambda c, cc, c2: c * c2 * (1 - cc * cc)
                     / (0.54 - 0.08 * cc * cc))


def correct_fn(window_type: WindowType):
    w = WindowType(window_type)
    if w == WindowType.HANN:
        return correct_hann
    if w == WindowType.HAMM:
        return correct_hamm
    return correct_rect
