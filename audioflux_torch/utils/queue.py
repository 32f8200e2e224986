"""Harmonic-ratio helpers over pitch-candidate frequencies.

Counterpart of ``audioflux_tpu/utils/queue.py``.  Reference
``python/audioflux/utils/queue.py`` binds ``__queue_fre2`` /
``__queue_fre3`` from ``src/mir/_queue.c``; here they delegate to the
ports in :mod:`audioflux_torch.mir._queue_util` (host code, no device),
reordered to the reference wrapper's return conventions.
"""

from __future__ import annotations

__all__ = ["queue_fre2", "queue_fre3"]


def queue_fre2(fre1: float, fre2: float):
    """Harmonic relation of two frequencies -> (k1, k2, n).

    ``n`` is the common base frequency (0 when none is found) with
    ``fre1 ~ k1*n`` and ``fre2 ~ k2*n``.
    """
    # imported here: ``audioflux_torch.mir`` imports the transforms, which
    # import this package
    from audioflux_torch.mir import _queue_util as _q
    fre, k1, k2 = _q.queue_fre2(float(fre1), float(fre2))
    return k1, k2, fre


def queue_fre3(fre1: float, fre2: float, fre3: float):
    """Harmonic relation of three ascending frequencies ->
    (s1, s2, k1, k2, k3, n): harmonic numbers k_i, spacing ratios s1/s2,
    and the base frequency n (0 when none is found)."""
    from audioflux_torch.mir import _queue_util as _q
    base, s1, s2, k1, k2, k3 = _q.queue_fre3(float(fre1), float(fre2),
                                             float(fre3))
    return s1, s2, k1, k2, k3, base
