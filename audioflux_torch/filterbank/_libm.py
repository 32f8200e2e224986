"""Vectorized glibc float32 libm (expf/cosf/sinf) via ctypes.

The reference C computes gammatone gains with float32 transcendentals whose
results feed catastrophic cancellations; matching within float tolerance
requires the *same* libm rounding. Host-side precompute only — never on the
device path. Falls back to NumPy float32 ops if libm is unavailable.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

__all__ = ["expf", "cosf", "sinf"]


def _load():
    try:
        path = ctypes.util.find_library("m") or "libm.so.6"
        lib = ctypes.CDLL(path)
        fns = {}
        for name in ("expf", "cosf", "sinf"):
            f = getattr(lib, name)
            f.restype = ctypes.c_float
            f.argtypes = [ctypes.c_float]
            fns[name] = f
        return fns
    except (OSError, AttributeError):
        return None


_FNS = _load()


def _vec(name, np_fallback):
    def apply(x):
        x = np.asarray(x, dtype=np.float32)
        if _FNS is None:
            return np_fallback(x).astype(np.float32)
        fn = _FNS[name]
        flat = x.reshape(-1)
        out = np.fromiter((fn(ctypes.c_float(float(v))) for v in flat),
                          dtype=np.float32, count=flat.size)
        return out.reshape(x.shape)
    return apply


expf = _vec("expf", np.exp)
cosf = _vec("cosf", np.cos)
sinf = _vec("sinf", np.sin)
