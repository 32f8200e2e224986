"""Spectral features: 30 frame-wise reductions over any band spectrogram.

Counterpart of ``audioflux_tpu/features/spectral.py`` (reference
``src/feature/spectral_algorithm.c`` + ``src/flux_spectral.c``): every
feature is a reduction over the band axis, batched over any leading dims.

Inputs are ``(..., fre, time)`` and outputs ``(..., time)``, the reference
Python API's layout; the reductions run over the last axis of
``(..., time, fre)``.  Band subsets (``set_edge`` / ``set_edge_arr``,
spectral_algorithm.c:163-218) are an index gather up front; hfc, decrease
and rms weigh by the *original* band indices, as the C kernels do.  The
band frequencies and index weights live on the plan's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.observe import scope
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.types import (SpectralNoveltyDataType,
                                   SpectralNoveltyMethodType)

__all__ = ["Spectral"]


def _safe_div(n, d):
    return torch.where(d != 0, n / torch.where(d == 0, torch.ones_like(d), d),
                       torch.zeros_like(n))


def _lead_pad(v, k):
    """Prepend ``k`` zero frames on the last axis."""
    return F.pad(v, (k, 0))


class Spectral:
    """Spectral feature extractor over ``num`` bands at ``fre_band_arr`` Hz.

    API mirrors ``python/audioflux/feature/spectral.py:15-2645``, plus
    ``device`` (``None`` means ``cuda``); ``set_time_length`` is kept as a
    no-op (shapes come from the data).
    """

    def __init__(self, num: int, fre_band_arr, device=None):
        if num < 2:
            raise ValueError("num must be >= 2")
        self.device = resolve_device(device)
        self.num = int(num)
        self.fre_band_arr = np.asarray(fre_band_arr, np.float32)
        self._set_idx(np.arange(self.num))

    # -- band subset ---------------------------------------------------------
    def set_time_length(self, time_length: int):  # compat no-op
        pass

    def set_edge(self, start: int, end: int):
        """Restrict features to band indices [start, end] (inclusive)."""
        if 0 <= start < end <= self.num - 1:
            self._set_idx(np.arange(start, end + 1))

    def set_edge_arr(self, index_arr):
        index_arr = np.asarray(index_arr, np.int64)
        if np.all((index_arr >= 0) & (index_arr <= self.num - 1)):
            self._set_idx(index_arr)

    def _set_idx(self, idx):
        """The band subset and the constants over it, on the device."""
        self._idx = np.asarray(idx, np.int64)
        self._build_exec()

    def _build_exec(self):
        dev, idx = self.device, self._idx
        self._fre = self.fre_band_arr[idx]
        self._fre_t = as_tensor(self._fre, dev)
        self._wix_t = as_tensor(idx.astype(np.float32), dev)
        self._idx_t = torch.from_numpy(idx).to(dev)
        self._all_bands = np.array_equal(idx, np.arange(self.num))
        w = np.ones(len(idx), np.float32)  # rms: half-weight DC/Nyquist
        w[idx == 0] = 0.5
        if self.num % 2 == 0:
            w[idx == self.num - 1] = 0.5
        self._rms_w_t = as_tensor(w, dev)

    def _prep(self, m_data_arr):
        """(..., fre, time) -> gathered (..., time, sub) float32."""
        x = as_tensor(m_data_arr, self.device).transpose(-1, -2)
        return x if self._all_bands else x.index_select(-1, self._idx_t)

    # -- features -------------------------------------------------------------
    def flatness(self, m_data_arr):
        """exp(mean log(x+2e-16)) / mean(x); 0 where mean(x)==0
        (flux_spectral.c:21-52)."""
        x = self._prep(m_data_arr)
        g = torch.exp(torch.log(x + 2.0e-16).mean(dim=-1))
        return _safe_div(g, x.mean(dim=-1))

    def flux(self, m_data_arr, step: int = 1, p: float = 2,
             is_positive: bool = False, is_exp: bool = False, tp: int = 0):
        """sum(|x_t - x_{t-step}|^p) (optionally ^1/p, mean, positive-only);
        the first ``step`` frames are 0 (flux_spectral.c:55-105)."""
        with scope("af.Spectral.flux"):
            x = self._prep(m_data_arr)
            step = max(int(step), 1)
            d = x[..., step:, :] - x[..., :-step, :]
            d = torch.clamp(d, min=0.0) if is_positive else d.abs()
            d = d * d if p == 2.0 else d.pow(p)
            v = d.sum(dim=-1)
            if tp:
                v = v / x.shape[-1]
            if is_exp:
                v = v.pow(1.0 / p)
            return _lead_pad(v, step)

    def rolloff(self, m_data_arr, threshold: float = 0.95):
        """Frequency below which ``threshold`` of |x|'s cumulative sum lies.

        The reference scales the *signed* band sum by threshold but
        accumulates |x| (flux_spectral.c:107-147): first original index
        where cumsum(|x|) >= threshold*sum(x); index 0 where none."""
        x = self._prep(m_data_arr)
        target = x.sum(dim=-1, keepdim=True) * threshold
        hit = torch.cumsum(x.abs(), dim=-1) >= target
        pos = torch.where(hit.any(dim=-1), hit.to(torch.int32).argmax(dim=-1),
                          torch.zeros((), dtype=torch.int64,
                                      device=x.device))
        return self._fre_t[pos]

    def centroid(self, m_data_arr):
        """sum(f*x)/sum(x) (flux_spectral.c:149-173)."""
        x = self._prep(m_data_arr)
        return _safe_div((self._fre_t * x).sum(dim=-1), x.sum(dim=-1))

    def _c12(self, x):
        f = self._fre_t
        s = x.sum(dim=-1)
        c1 = _safe_div((f * x).sum(dim=-1), s)
        d = f - c1[..., None]
        c2 = torch.sqrt(_safe_div((d * d * x).sum(dim=-1), s))
        return d, s, c1, c2

    def spread(self, m_data_arr):
        """sqrt(sum((f-c)^2 x)/sum(x)) (flux_spectral.c:175-201)."""
        return self._c12(self._prep(m_data_arr))[3]

    # the moments multiply out d*d*d and (d*d)*(d*d) as the reference and
    # the TPU package do: their sums cancel, so pow()'s rounding would show

    def skewness(self, m_data_arr):
        """Third central moment / (spread^3 * sum) (flux_spectral.c:203-229)."""
        x = self._prep(m_data_arr)
        d, s, c1, c2 = self._c12(x)
        n = (d * d * d * x).sum(dim=-1)
        return _safe_div(n, c2 * c2 * c2 * s)

    def kurtosis(self, m_data_arr):
        """Fourth central moment / (spread^4 * sum) (flux_spectral.c:231-257)."""
        x = self._prep(m_data_arr)
        d, s, c1, c2 = self._c12(x)
        d2, c22 = d * d, c2 * c2
        n = (d2 * d2 * x).sum(dim=-1)
        return _safe_div(n, c22 * c22 * s)

    def entropy(self, m_data_arr, is_norm: bool = False):
        """-sum(p log2(p+1e-16)), p = x/sum(x); /log2(len) if is_norm
        (flux_spectral.c:259-290)."""
        x = self._prep(m_data_arr)
        p = x / x.sum(dim=-1, keepdim=True)
        n = -(p * torch.log2(p + 1e-16)).sum(dim=-1)
        if is_norm:
            n = n / np.float32(np.log2(len(self._idx)))
        return n

    def crest(self, m_data_arr):
        """max(x) / mean(x) (flux_spectral.c:292-319)."""
        x = self._prep(m_data_arr)
        return _safe_div(x.amax(dim=-1), x.mean(dim=-1))

    def slope(self, m_data_arr):
        """Least-squares slope of x over f (flux_spectral.c:321-347)."""
        x = self._prep(m_data_arr)
        df = self._fre_t - self._fre_t.mean()
        n = (df * (x - x.mean(dim=-1, keepdim=True))).sum(dim=-1)
        return _safe_div(n, (df * df).sum().expand(n.shape))

    def decrease(self, m_data_arr):
        """sum_{k>0}((x_k-x_0)/index_k) / (sum(x)-x_0); index is the ORIGINAL
        band index (flux_spectral.c:349-373)."""
        x = self._prep(m_data_arr)
        x0 = x[..., :1]
        n = ((x[..., 1:] - x0) / self._wix_t[1:]).sum(dim=-1)
        return _safe_div(n, x.sum(dim=-1) - x0[..., 0])

    def band_width(self, m_data_arr, p: float = 2):
        """(sum(x*(f-c)^p))^(1/p) (flux_spectral.c:375-410)."""
        x = self._prep(m_data_arr)
        f = self._fre_t
        c = _safe_div((f * x).sum(dim=-1), x.sum(dim=-1))
        d = f - c[..., None]
        d = d * d if p == 2.0 else d.pow(p)
        v = (x * d).sum(dim=-1)
        if p != 1.0:
            v = v.pow(1.0 / p)
        return v

    def rms(self, m_data_arr):
        """sqrt(2*sum(x^2 with half-weight DC/Nyquist)/num^2)
        (flux_spectral.c:412-438)."""
        x = self._prep(m_data_arr)
        v = (x * x * self._rms_w_t).sum(dim=-1)
        return torch.sqrt(2.0 * v / float(self.num) ** 2)

    def energy(self, m_data_arr, is_log: bool = False, gamma: float = 10.0):
        """mean over bands of x^2 (optionally log(1+gamma*x^2))
        (flux_spectral.c:787-823; its caller passes isPower=0)."""
        x = self._prep(m_data_arr)
        v = x * x
        if is_log:
            if gamma <= 0:
                gamma = 10.0
            v = torch.log(1.0 + gamma * v)
        return v.mean(dim=-1)

    def hfc(self, m_data_arr):
        """sum(x * original_band_index) (flux_spectral.c:441-462)."""
        return (self._prep(m_data_arr) * self._wix_t).sum(dim=-1)

    def sd(self, m_data_arr, step: int = 1, is_positive: bool = False):
        """flux with p=1 (flux_spectral.c:465-495)."""
        return self.flux(m_data_arr, step=step, p=1.0,
                         is_positive=is_positive)

    def sf(self, m_data_arr, step: int = 1, is_positive: bool = False):
        """flux with p=2 (flux_spectral.c:498-525)."""
        return self.flux(m_data_arr, step=step, p=2.0,
                         is_positive=is_positive)

    def mkl(self, m_data_arr, tp: int = 0):
        """sum(log(1 + x_t/(x_{t-1}+1e-16))); frame 0 is 0
        (flux_spectral.c:528-553)."""
        x = self._prep(m_data_arr)
        v = torch.log1p(x[..., 1:, :] / (x[..., :-1, :] + 1e-16)).sum(dim=-1)
        if tp:
            v = v / x.shape[-1]
        return _lead_pad(v, 1)

    # -- phase-based ----------------------------------------------------------
    def _pd(self, m_spec_arr, m_phase_arr, is_weight, is_norm):
        """mean |phi_t - 2 phi_{t-1} + phi_{t-2}| (optionally spec-weighted /
        spec-mean-normalized); frames 0, 1 are 0 (flux_spectral.c:556-653)."""
        s = self._prep(m_spec_arr)
        ph = self._prep(m_phase_arr)
        d = (ph[..., 2:, :] - 2 * ph[..., 1:-1, :] + ph[..., :-2, :]).abs()
        if is_weight or is_norm:
            d = d * s[..., 2:, :]
        v = d.mean(dim=-1)
        if is_norm:
            v = v / (s[..., 2:, :].mean(dim=-1) + 1e-16)
        return _lead_pad(v, 2)

    def pd(self, m_data_arr, m_phase_arr):
        return self._pd(m_data_arr, m_phase_arr, False, False)

    def wpd(self, m_data_arr, m_phase_arr):
        return self._pd(m_data_arr, m_phase_arr, True, False)

    def nwpd(self, m_data_arr, m_phase_arr):
        return self._pd(m_data_arr, m_phase_arr, False, True)

    def _cd(self, m_spec_arr, m_phase_arr, is_rectify):
        """Complex-domain deviation |S_t e^{i phi_t} - S_{t-1} e^{i(2phi_{t-1}
        - phi_{t-2})}|; frame 0 is 0, frame 1 has no prediction term
        (flux_spectral.c:656-730)."""
        s = self._prep(m_spec_arr)
        ph = self._prep(m_phase_arr)
        T = s.shape[-2]
        cur = torch.complex(s * torch.cos(ph), s * torch.sin(ph))
        tgt = 2 * ph[..., 1:-1, :] - ph[..., :-2, :]
        pred = torch.complex(s[..., 1:-1, :] * torch.cos(tgt),
                             s[..., 1:-1, :] * torch.sin(tgt))
        diffs = (cur[..., 2:, :] - pred).abs()
        d = torch.cat([cur[..., 1:2, :].abs(), diffs], dim=-2) if T > 1 \
            else diffs
        if is_rectify:
            keep = s[..., 1:, :] > s[..., :-1, :]
            d = torch.where(keep, d, torch.zeros_like(d))
        return _lead_pad(d.sum(dim=-1), 1)

    def cd(self, m_data_arr, m_phase_arr):
        return self._cd(m_data_arr, m_phase_arr, False)

    def rcd(self, m_data_arr, m_phase_arr):
        return self._cd(m_data_arr, m_phase_arr, True)

    def broadband(self, m_data_arr, threshold: float = 0):
        """count of bands with 10*log10(x_t/x_{t-1}) > threshold; frame 0 is 0
        (flux_spectral.c:733-751)."""
        x = self._prep(m_data_arr)
        r = 10.0 * torch.log10(x[..., 1:, :] / x[..., :-1, :])
        return _lead_pad((r > threshold).to(torch.float32).sum(dim=-1), 1)

    def novelty(self, m_data_arr, step: int = 1, threshold: float = 0.0,
                method_type=0, data_type=0):
        """Novelty via sub/entroy/KL/IS distance, value-sum or count above
        threshold (flux_spectral.c:754-833)."""
        mt = SpectralNoveltyMethodType(method_type)
        dt = SpectralNoveltyDataType(data_type)
        x = self._prep(m_data_arr)
        step = max(int(step), 1)
        cur, pre = x[..., step:, :], x[..., :-step, :]
        if mt == SpectralNoveltyMethodType.SUB:
            d = cur - pre
        elif mt == SpectralNoveltyMethodType.ENTROY:
            d = torch.log(cur / (pre + 1e-16))
        elif mt == SpectralNoveltyMethodType.KL:
            d = cur * torch.log(cur / (pre + 1e-16))
        else:  # IS
            r = cur / (pre + 1e-16)
            d = r - torch.log(r) - 1.0
        mask = d > threshold
        if dt == SpectralNoveltyDataType.VALUE:
            v = torch.where(mask, d, torch.zeros_like(d)).sum(dim=-1)
        else:
            v = mask.to(torch.float32).sum(dim=-1)
        return _lead_pad(v, step)

    def eef(self, m_data_arr, is_norm: bool = False):
        """sqrt(1+|energy*entropy|) (spectral_algorithm.c:757-816)."""
        e = self.energy(m_data_arr)
        h = self.entropy(m_data_arr, is_norm)
        return torch.sqrt(1.0 + (e * h).abs())

    def eer(self, m_data_arr, is_norm: bool = False, gamma: float = 1.0):
        """sqrt(1+|log(1+gamma*energy)/entropy|)
        (spectral_algorithm.c:818-871)."""
        e = self.energy(m_data_arr)
        h = self.entropy(m_data_arr, is_norm)
        return torch.sqrt(1.0 + (torch.log1p(gamma * e) / h).abs())

    # -- statistics ------------------------------------------------------------
    def max(self, m_data_arr):
        """(max value, freq of max) per frame (spectral_algorithm.c:874-917)."""
        x = self._prep(m_data_arr)
        return x.amax(dim=-1), self._fre_t[x.argmax(dim=-1)]

    def mean(self, m_data_arr):
        """(mean value, mean band freq) per frame
        (spectral_algorithm.c:919-927)."""
        v = self._prep(m_data_arr).mean(dim=-1)
        return v, torch.full_like(v, float(np.mean(self._fre)))

    def var(self, m_data_arr):
        """(sample variance of values, of band freqs) per frame, ddof=1
        (spectral_algorithm.c:929-987)."""
        v = self._prep(m_data_arr).var(dim=-1, correction=1)
        fvar = float(np.var(self._fre.astype(np.float64), ddof=1))
        return v, torch.full_like(v, fvar)
