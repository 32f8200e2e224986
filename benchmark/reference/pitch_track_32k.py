"""Plain reference of ``pitch_track_32k``: frame-wise pitch by NCF, HPS
and PEF and the harmonic ratio, for recordings (rows, n).  Every output is
(rows, T) with T = (n - frame) // slide + 1 frames, frame t the samples
``[t slide, t slide + frame)``.

- NCF (``_pitch_ncf.c``): the frame (RECT: as it is) transformed at twice
  its length, ``acf = irfft(|F|^2) / sqrt(2 N)``, over ``sqrt(acf[0])``;
  the first largest over the lags ``[round(sr / high), round(sr / low)]``;
  the pitch ``sr / lag``.
- HPS (``_pitch_hps.c``): |F| of the Hamming-windowed frame at X points, X
  the power of two nearest ``sr``; the product over h = 1..H of |F[j h]|
  for j <= floor(high), H the harmonic count cut to ``sr // (floor(high) +
  1)``; the first largest over ``j in [ceil(low), floor(high)]``; the
  pitch ``(j + 1) sr / X`` (the C's bin index plus one).
- PEF (``_pitch_pef.c``): the power of the Hamming-windowed frame at 2 N
  (bins 0..N); linearly interpolated from the linear grid ``i sr / (2 N)``
  onto 2 N log-spaced points from 10 Hz to the cut (``10^(1 .. log10
  cut)``, the end exponent held in float32), each interval's left point
  the last grid point below; times the band widths ``(f[i + 1] - f[i -
  1]) / (4 N)`` (the ends copy their neighbours); placed at ``pad_num`` of
  X zeros (X = 2^(radix2_exp + 3) where pad_num > 0, else 2^(radix2_exp +
  2)); cross-correlated with the comb filter ``1 / (gamma - cos(2 pi
  q))`` over N points ``q`` log-spaced from beta to alpha + beta, less its
  mean weighted by the points' cell widths (``pad_num`` is the count of q
  under 1); the first largest over the log grid's ``[min_index,
  max_index]``, each the nearer grid point to low and high; the pitch the
  grid's frequency there.
- HarmonicRatio (``harmonicRatio_algorithm.c:58-231``): Hamming frames of
  W = 2^radix2_exp samples; their autocorrelation at 2 W lags 0..M (M =
  min(floor(sr / low), W - 1), low C1 = 32.70 Hz by default); the tail
  energy ``E[j]``, the sum of the squares of the frame's first W - 1 - j
  samples; the first sign change of the autocorrelation over j = 2..M
  (``acf[j]`` and ``acf[j - 1]`` on both sides of 0, or one of them 0)
  gives ``m = j - 1``, else m = 0; ``gamma[j] = acf[j] / sqrt(acf[0]
  E[j] + 1e-16)``; the first largest over ``m < j < M``; the parabola
  through its neighbours, ``v2 - (v1 - v3) p / 4`` with ``p = (v3 - v1) /
  (2 (2 v2 - v3 - v1) + 1e-16)``, except at j = m + 1 or j >= M - 1,
  where the largest value itself.

Departures from the C: every sum and transform is in float64 (the C's are
float32); the log grid is computed in float64, and the windows, the
interpolation weights, the band widths and the comb filter computed from
it are rounded to float32, as the C stores them, and used in float64 (the
C's band widths, differences of neighbouring float32 grid points, carry up
to 5e-4 of rounding at the grid's low end; these do not); the log grid's
frequencies are rounded to float32 where they are returned; the
autocorrelations and spectra come from FFTs of the whole frame, which
is what the C's transforms compute.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import common

FRAMES_PER_BLOCK = 2048
HR_FLIP = 1e-4   # a harmonic ratio differs where it is off by more than this
STEP_FLIP = 1.5  # a pitch differs where it is more than one grid step off
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "pitch_track_32k.json"


def window(kind: str, n: int) -> np.ndarray:
    """The analysis window (float64 of the float32 the C stores)."""
    if kind == "RECT":
        return np.ones(n)
    return common.fft_window(kind.lower(), n).astype(np.float32).astype(
        np.float64)


def round_pow2(n: int) -> int:
    """The power of two nearest ``n`` (the lower one on a tie)."""
    lo = 1 << (int(n).bit_length() - 1)
    return 2 * lo if n - lo > 2 * lo - n else lo


def nearest_index(grid: np.ndarray, f: float) -> int:
    """The index of the grid point nearer ``f``, of the first pair of
    points around it (``_pitch_pef.c``'s pick)."""
    i = int(np.searchsorted(grid, f, side="right"))
    i = min(max(i, 1), len(grid) - 1)
    return i if grid[i] - f < f - grid[i - 1] else i - 1


class Pef:
    """PEF's grids and filter for a plan."""

    def __init__(self, p: dict):
        n = 1 << p["radix2_exp"]
        sr = p["samplate"]
        cut = p["cut_fre"] if p["cut_fre"] > p["high_fre"] else p["high_fre"]
        top = cut if sr / 2 > cut else sr / 2 - 1
        end = float(np.float32(np.log10(np.float32(top))))
        self.log_fre = 10.0 ** np.linspace(1.0, end, 2 * n)
        self.min_index = nearest_index(self.log_fre, p["low_fre"])
        self.max_index = nearest_index(self.log_fre, p["high_fre"])
        lin = np.arange(n + 1) * (sr / 2) / n
        lf = self.log_fre
        self.pos = np.clip(np.searchsorted(lin, lf, side="left") - 1, 0,
                           n - 1)
        self.weight = ((lf - lin[self.pos]) / (lin[self.pos + 1]
                                               - lin[self.pos]))
        bw = np.empty(2 * n)
        bw[1:-1] = (lf[2:] - lf[:-2]) / (4 * n)
        bw[0], bw[-1] = bw[1], bw[-2]
        self.band_width = bw
        q = 10.0 ** np.linspace(math.log10(p["beta"]),
                                math.log10(p["alpha"] + p["beta"]), n)
        h = 1.0 / (p["gamma"] - np.cos(2 * np.pi * q))
        edges = np.concatenate([q[:1], (q[:-1] + q[1:]) / 2, q[-1:]])
        cell = np.diff(edges)
        self.filter = h - (cell * h).sum() / cell.sum()
        self.pad_num = int((q < 1).sum())
        self.xcorr_n = 1 << (p["radix2_exp"] + (3 if self.pad_num else 2))
        self.log_step = (end - 1.0) * math.log(10.0) / (2 * n - 1)
        for k in ("weight", "band_width", "filter"):
            setattr(self, k, getattr(self, k).astype(np.float32).astype(
                np.float64))


def ncf_lags(p: dict):
    """NCF's (first, last) lag."""
    return (int(round(p["samplate"] / p["high_fre"])),
            int(round(p["samplate"] / p["low_fre"])))


def hps_grid(p: dict):
    """HPS's (X, first bin, last bin, harmonics)."""
    sr = p["samplate"]
    lo, hi = int(math.ceil(p["low_fre"])), int(math.floor(p["high_fre"]))
    harmonics = p["harmonic_count"] or 5
    if harmonics > sr // (hi + 1):
        harmonics = max(sr // (hi + 1), 1)
    return round_pow2(sr), lo, hi, harmonics


def hr_low(p: dict) -> float:
    low = p["low_fre"]
    if low is None:
        return 440.0 * 2.0 ** (-45 / 12)   # C1
    return float(low) if 0 < low < p["samplate"] / 2 else 25.0


def hr_max_lag(p: dict) -> int:
    """HarmonicRatio's M, the lags 0..M of its autocorrelation."""
    w = 1 << p["radix2_exp"]
    return min(int(math.floor(p["samplate"] / hr_low(p))), w - 1)


@functools.lru_cache(maxsize=None)
def grid_steps(path: str = str(CONFIG)) -> dict:
    """The configuration's grid steps, as compare reads them: NCF's lag in
    samples of ``sr``, HPS's bin ``sr / X`` in Hz, PEF's log-grid ratio's
    natural log."""
    with open(path) as f:
        plans = json.load(f)["plans"]
    return {"sr": float(plans["ncf"]["samplate"]),
            "hps_hz": plans["hps"]["samplate"] / hps_grid(plans["hps"])[0],
            "pef_log": Pef(plans["pef"]).log_step}


class Reference:
    def __init__(self, cfg: dict, device):
        # float32 products stay float32, as the configuration states
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p = cfg["plans"]
        self.ncf, self.hps, self.pef, self.hr = (p[k] for k in
                                                 ("ncf", "hps", "pef", "hr"))
        self.ncf_lags = ncf_lags(self.ncf)
        self.hps_grid = hps_grid(self.hps)
        self.pef_grid = Pef(self.pef)
        self.hr_m = hr_max_lag(self.hr)
        self.windows = {k: torch.from_numpy(window(
            v["window_type"], (1 << v["radix2_exp"])))
            for k, v in p.items()}

    def _frames(self, x, key, prec, t0, t1):
        """Frames t0..t1-1 of (n,) ``x`` for plan ``key``, windowed."""
        p = getattr(self, key)
        n, slide = 1 << p["radix2_exp"], p["slide_length"]
        idx = (torch.arange(t0, t1, device=x.device)[:, None] * slide
               + torch.arange(n, device=x.device)[None, :])
        return prec.q(x[idx] * self.windows[key].to(x.device, prec.dtype))

    # -- the four estimators on a block of frames ---------------------------
    def _ncf(self, fr, prec):
        q = prec.q
        n2 = 2 * fr.shape[-1]
        lo, hi = self.ncf_lags
        spec = q(torch.fft.rfft(fr, n=n2, dim=-1))
        acf = q(torch.fft.irfft(q(spec.real ** 2 + spec.imag ** 2), n=n2,
                                dim=-1)[:, :hi + 1] / math.sqrt(n2))
        lags = q(acf[:, lo:] / torch.sqrt(acf[:, :1]))
        lag = torch.argmax(lags, dim=-1) + lo
        return self.ncf["samplate"] / lag.to(prec.dtype)

    def _hps(self, fr, prec):
        q = prec.q
        big, lo, hi, harmonics = self.hps_grid
        j = torch.arange(hi + 1, device=fr.device)
        spec = torch.fft.rfft(fr, n=big, dim=-1)[:, :hi * harmonics + 1]
        mag = q(spec.abs())
        del spec
        prod = mag[:, j]
        for h in range(2, harmonics + 1):
            prod = q(prod * mag[:, j * h])
        pick = torch.argmax(prod[:, lo:], dim=-1) + lo
        return (pick + 1).to(prec.dtype) * (self.hps["samplate"] / big)

    def _pef(self, fr, prec):
        q, g, dev = prec.q, self.pef_grid, fr.device
        n = fr.shape[-1]
        spec = torch.fft.rfft(fr, n=2 * n, dim=-1)
        power = q(spec.real ** 2 + spec.imag ** 2)
        del spec
        pos = torch.from_numpy(g.pos).to(dev)
        w = torch.from_numpy(g.weight).to(dev, prec.dtype)
        p1, p2 = power[:, pos], power[:, pos + 1]
        logp = q(q(p1 + w * (p2 - p1))
                 * torch.from_numpy(g.band_width).to(dev, prec.dtype))
        del power, p1, p2
        big = g.xcorr_n
        buf = torch.zeros(fr.shape[0], big, dtype=prec.dtype, device=dev)
        buf[:, g.pad_num:g.pad_num + 2 * n] = logp
        del logp
        flt = torch.zeros(big, dtype=prec.dtype, device=dev)
        flt[:n] = torch.from_numpy(g.filter).to(dev, prec.dtype)
        prod = q(q(torch.fft.rfft(buf, dim=-1))
                 * q(torch.fft.rfft(flt)).conj())
        del buf
        xc = q(torch.fft.irfft(prod, n=big, dim=-1)[:, :g.max_index + 1])
        lag = torch.argmax(xc[:, g.min_index:], dim=-1) + g.min_index
        fre = torch.from_numpy(g.log_fre.astype(np.float32)).to(dev)
        return fre[lag].to(prec.dtype)

    def _hr(self, fr, prec):
        q, m = prec.q, self.hr_m
        w = fr.shape[-1]
        spec = torch.fft.rfft(fr, n=2 * w, dim=-1)
        acf = q(torch.fft.irfft(q(spec.real ** 2 + spec.imag ** 2),
                                n=2 * w, dim=-1)[:, :m + 1])
        del spec
        energy = q(torch.cumsum(q(fr * fr), dim=-1))
        tail = energy[:, w - 2 - torch.arange(m, device=fr.device)]
        prev, cur = acf[:, 1:m], acf[:, 2:m + 1]
        cross = ((cur >= 0) & (prev <= 0)) | ((cur <= 0) & (prev >= 0))
        first = torch.argmax(cross.to(torch.uint8), dim=-1) + 1
        low = torch.where(cross.any(dim=-1), first, 0)
        gamma = q(acf[:, :m] / torch.sqrt(acf[:, :1] * tail + 1e-16))
        lag = torch.arange(m, device=fr.device)
        pick = torch.argmax(torch.where(lag > low[:, None], gamma,
                                        -torch.inf), dim=-1)

        def at(k):
            return gamma.gather(1, k.clamp(0, m - 1)[:, None])[:, 0]
        v1, v2, v3 = at(pick - 1), at(pick), at(pick + 1)
        p = (v3 - v1) / (2.0 * (2.0 * v2 - v3 - v1) + 1e-16)
        top = q(v2 - 0.25 * (v1 - v3) * p)
        edge = (pick == low + 1) | (pick >= m - 1)
        return torch.where(edge, v2, top)

    def run(self, x: torch.Tensor, precision: str = "float64") -> dict:
        """x (rows, n) float32 -> {"ncf", "hps", "pef", "hr"}, each (rows,
        T), on x's device: float64 for the reference proper, float32
        else."""
        prec = common.Precision(precision)
        xd = x.to(prec.dtype)
        rows, n = x.shape
        engines = (("ncf", self._ncf), ("hps", self._hps),
                   ("pef", self._pef), ("hr", self._hr))
        res = {}
        for key, fn in engines:
            p = getattr(self, key)
            t = common.n_frames(n, 1 << p["radix2_exp"], p["slide_length"])
            out = torch.empty(rows, t, dtype=prec.dtype, device=x.device)
            for r in range(rows):
                xr = prec.q(xd[r])
                for t0, t1 in common.frame_blocks(t, FRAMES_PER_BLOCK):
                    out[r, t0:t1] = fn(self._frames(xr, key, prec, t0, t1),
                                       prec)
            res[key] = out
        return res


def _flat(t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float64).reshape(-1)


def grid_distance(got: dict, ref: dict, steps: dict) -> dict:
    """Per frame, each estimator's distance from the reference's pitch in
    steps of its own grid: lags (NCF), bins (HPS), log-grid points (PEF).
    A pitch that is not finite and positive is infinitely far."""
    out = {}
    for key in ("ncf", "hps", "pef"):
        g, r = _flat(got[key]), _flat(ref[key])
        if key == "ncf":
            d = (steps["sr"] / g - steps["sr"] / r).abs()
        elif key == "hps":
            d = (g - r).abs() / steps["hps_hz"]
        else:
            d = torch.log(g / r).abs() / steps["pef_log"]
        bad = ~(torch.isfinite(g) & (g > 0))
        out[key] = torch.where(bad | torch.isnan(d), torch.inf, d)
    return out


def compare(got: dict, ref: dict) -> dict:
    """The numbers ``correct`` is decided on:

    - ``ncf_flips``, ``hps_flips``, ``pef_flips``: the share of frames
      whose pitch lies more than one step of the estimator's grid from the
      reference's (a lag; a bin of sr / X; a point of the log grid);
    - ``hr_flips``: the share of frames whose harmonic ratio is off the
      reference's by more than ``HR_FLIP``;
    - ``hr_gap``: the mean |gap| of the other frames.
    """
    dist = grid_distance(got, ref, grid_steps())
    res = {f"{k}_flips": float((~(d <= STEP_FLIP)).double().mean())
           for k, d in dist.items()}
    gap = (_flat(got["hr"]) - _flat(ref["hr"])).abs()
    keep = gap <= HR_FLIP
    res["hr_flips"] = float((~keep).double().mean())
    res["hr_gap"] = float(gap[keep].mean()) if bool(keep.any()) else 1.0
    return res
