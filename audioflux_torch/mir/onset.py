"""Onset detection: novelty + normalization + peak-picking.

Counterpart of ``audioflux_tpu/mir/onset.py`` (reference
``src/mir/onset_algorithm.c``): optional frequency-axis max filter
(:_onsetObj_dealFilterArr), one of 11 novelty functions (the ``Spectral``
features, on the plan's device), min-subtract/max-divide normalization,
then sequential peak-picking with preMax/postMax/preAvg/postAvg/wait/delta
(:__peakPick).  The peak-pick runs in numpy on the fetched envelope: it is
sequential through ``wait``, in the reference too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from audioflux_torch.features.spectral import Spectral
from audioflux_torch.observe import scope
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.filter import max_filter
from audioflux_torch.types import NoveltyType

__all__ = ["Onset", "NoveltyParam", "peak_pick"]


@dataclass
class NoveltyParam:
    """Mirrors the C NoveltyParam struct (onset_algorithm.h:30-41)."""
    step: int = 1
    p: float = 1.0
    is_positive: int = 1
    is_exp: int = 0
    tp: int = 0
    threshold: float = 0.0
    is_norm: int = 0
    gamma: float = 1.0


def peak_pick(env: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
              post_avg: int, wait: int, delta: float) -> np.ndarray:
    """Peak-pick (onset_algorithm.c:__peakPick) of a 1-D numpy envelope.

    The local-max and local-mean gates are vectorized (sliding windows,
    the same pairwise-mean semantics as the per-index slice form); only
    the ``wait`` suppression is sequential, over the surviving candidates.
    """
    with scope("af.peak_pick"):
        env = np.asarray(env)
        n = len(env)
        if n == 0:
            return np.asarray([], np.int64)
        swv = np.lib.stride_tricks.sliding_window_view

        # max over the clamped window [max(i-pre_max,0), min(i-1+post_max,n-1)]
        # (-inf padding == clamping for a max)
        w1 = pre_max + post_max
        pad1 = np.concatenate([np.full(pre_max, -np.inf, env.dtype), env,
                               np.full(max(post_max - 1, 0), -np.inf,
                                       env.dtype)])
        is_max = env == swv(pad1, w1)[:n].max(axis=-1)

        # mean over the clamped window: interior rows by a sliding view (the
        # same np.mean reduction as env[s2:e2+1].mean()), truncated edge
        # windows directly
        w2 = pre_avg + post_avg
        mean_ok = np.zeros(n, bool)
        lo, hi = pre_avg, n - post_avg  # rows whose window is untruncated
        if hi > lo:
            mean_ok[lo:hi] = env[lo:hi] >= (
                swv(env, w2)[:hi - lo].mean(axis=-1) + delta)
        for i in list(range(min(lo, n))) + list(range(max(hi, 0), n)):
            s2 = max(i - pre_avg, 0)
            e2 = i - 1 + post_avg if i + post_avg < n else n - 1
            mean_ok[i] = env[i] >= env[s2:e2 + 1].mean() + delta

        points = []
        pre = -wait - 1
        for i in np.flatnonzero(is_max & mean_ok):
            if i - pre > wait:
                points.append(i)
                pre = i
        return np.asarray(points, np.int64)


class Onset:
    """API mirrors ``python/audioflux/mir/onset.py:97-250``, plus
    ``device`` (``None`` means ``cuda``)."""

    def __init__(self, time_length: int, fre_length: int, slide_length: int,
                 samplate: int = 32000, filter_order: int = 1,
                 novelty_type: NoveltyType = NoveltyType.FLUX, device=None):
        self.device = resolve_device(device)
        self.time_length = time_length
        self.fre_length = fre_length
        self.slide_length = slide_length
        self.samplate = samplate
        self.filter_order = filter_order
        self.novelty_type = NoveltyType(novelty_type)
        # peak-pick window sizes (onset_algorithm.c:125-132)
        self.pre_max = int(np.floor(0.03 * samplate / slide_length))
        self.post_max = int(np.floor(0.0 * samplate / slide_length + 1))
        self.pre_avg = int(np.floor(0.1 * samplate / slide_length))
        self.post_avg = int(np.floor(0.1 * samplate / slide_length + 1))
        self.wait = int(np.floor(0.03 * samplate / slide_length))
        self.delta = 0.07
        self._sp = Spectral(fre_length, np.zeros(fre_length, np.float32),
                            device=self.device)

    def onset(self, m_data_arr1, m_data_arr2=None, novelty_param=None,
              index_arr=None):
        """Detect onsets on a (fre, time) spectrogram (the phase matrix is
        needed for PD/WPD/NWPD/CD/RCD).  Returns (point_arr, evn_arr,
        time_arr) as numpy arrays."""
        param = novelty_param or NoveltyParam()
        N = NoveltyType
        sp = self._sp
        if index_arr is not None:
            sp = Spectral(self.fre_length, sp.fre_band_arr,
                          device=self.device)
            sp.set_edge_arr(np.asarray(index_arr, np.int64))

        S = as_tensor(m_data_arr1, self.device)
        if self.filter_order > 1:
            S = max_filter(S, self.filter_order, dim=-2)  # frequency axis

        t = self.novelty_type
        if t == N.HFC:
            env = sp.hfc(S)
        elif t == N.SD:
            env = sp.sd(S, step=param.step, is_positive=bool(param.is_positive))
        elif t == N.SF:
            env = sp.sf(S, step=param.step, is_positive=bool(param.is_positive))
        elif t == N.MKL:
            env = sp.mkl(S, tp=param.tp)
        elif t in (N.PD, N.WPD, N.NWPD, N.CD, N.RCD):
            if m_data_arr2 is None:
                raise ValueError(f"{t.name} novelty needs the phase matrix")
            env = {N.PD: sp.pd, N.WPD: sp.wpd, N.NWPD: sp.nwpd,
                   N.CD: sp.cd, N.RCD: sp.rcd}[t](S, m_data_arr2)
        elif t == N.BROADBAND:
            env = sp.broadband(S, threshold=param.threshold)
        else:
            env = sp.flux(S, step=param.step, p=param.p,
                          is_positive=bool(param.is_positive),
                          is_exp=bool(param.is_exp), tp=param.tp)

        env = env.cpu().numpy().astype(np.float32)
        env = env - env.min()
        mx = env.max()
        if mx > 0:
            env = env / mx
        points = peak_pick(env, self.pre_max, self.post_max, self.pre_avg,
                           self.post_avg, self.wait, self.delta)
        times = points * self.slide_length / self.samplate
        return points, env, times
