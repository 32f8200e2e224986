"""A/B/C/D frequency weighting curves (dB).

Reference ``src/filterbank/auditory_weight.c``; all floored at -80 dB.

A copy of ``audioflux_tpu/utils/weight.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["weight_a", "weight_b", "weight_c", "weight_d"]

_MIN = -80.0


def weight_a(fre_arr):
    f2 = np.asarray(fre_arr, np.float64) ** 2
    c = (12200.0 ** 2, 20.6 ** 2, 107.7 ** 2, 737.9 ** 2)
    v = 2.0 + 20 * (np.log10(c[0]) + 2 * np.log10(f2)
                    - np.log10(f2 + c[0]) - np.log10(f2 + c[1])
                    - 0.5 * np.log10(f2 + c[2]) - 0.5 * np.log10(f2 + c[3]))
    return np.maximum(v, _MIN).astype(np.float32)


def weight_b(fre_arr):
    f2 = np.asarray(fre_arr, np.float64) ** 2
    c = (12194.0 ** 2, 20.6 ** 2, 158.5 ** 2)
    v = 0.17 + 20 * (np.log10(c[0]) + 1.5 * np.log10(f2)
                     - np.log10(f2 + c[0]) - np.log10(f2 + c[1])
                     - 0.5 * np.log10(f2 + c[2]))
    return np.maximum(v, _MIN).astype(np.float32)


def weight_c(fre_arr):
    f2 = np.asarray(fre_arr, np.float64) ** 2
    c = (12194.0 ** 2, 20.6 ** 2)
    v = 0.062 + 20 * (np.log10(c[0]) + np.log10(f2)
                      - np.log10(f2 + c[0]) - np.log10(f2 + c[1]))
    return np.maximum(v, _MIN).astype(np.float32)


def weight_d(fre_arr):
    f2 = np.asarray(fre_arr, np.float64) ** 2
    c = ((8.3046305e-3) ** 2, 1018.7 ** 2, 1039.6 ** 2, 3136.5 ** 2,
         3424.0 ** 2, 282.7 ** 2, 1160.0 ** 2)
    v = 20 * (0.5 * np.log10(f2) - np.log10(c[0])
              + 0.5 * (np.log10((c[1] - f2) ** 2 + c[2] * f2)
                       - np.log10((c[3] - f2) * (c[1] - f2) + c[4] * f2)
                       - np.log10(c[5] + f2) - np.log10(c[6] + f2)))
    return np.maximum(v, _MIN).astype(np.float32)
