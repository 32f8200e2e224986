"""Plain reference of ``cwt_synsq_32k``: the morlet CWT of clips of n
samples on an octave scale, then its synchrosqueezing, for (clips, n)
audio.  Both outputs (clips, num, n), rows ascending in frequency.

- CWT (``cwt_algorithm.c``, ``cwt_filterBank.c``): ``pad`` samples a side
  mirrored with the edge sample repeated (n / 2 up to 1e5 samples, else
  ceil(log2 n)); one FFT of the padded signal; the morlet bank
  ``2 exp(-(s w - cf)^2 / beta)`` for ``s w > 0`` (cf = gamma, s = cf /
  (2 pi f / samplate), w the FFT's angular frequencies, the upper half
  negative); one inverse FFT a band; the pad cut away.  The band
  frequencies are ``440 * 2^(k / bpo)`` for the ``num`` notes from
  ``round(bpo log2(low_fre / 440))`` (the constructor's edge revision,
  ``cwt_algorithm.c:183-207``; the bank's own revision adds one note a
  side and keeps the inner ``num``).
- Synchrosqueezing (``synsq_algorithm.c``), order 1: the phase
  ``atan2(Re, Im)`` (:155); its backward difference along time with the C
  unwrap's wrap count (``__vunwrap``: where ``|d| >= pi``, ``t =
  floor(|d| / 2 pi)`` plus one where the rest passes pi, subtracted where
  the phase rose, added where it fell); the first column 0 and the last a
  copy of the one before (:191-193); over 2 pi, the phase rate in cycles a
  sample; the bin ``floor((log2 |v| - log2 f0) num / (log2 f1 - log2 f0) +
  0.5)`` with f0, f1 the first and last band over the rate (:201-217); a
  cell is dropped outside ``[0, num)`` or where its power is not above
  ``thresh^2``; the cells of each time column added into their bins.

Departures from the C: the difference of the unwrapped phase is taken
from the wrap count of each step alone, which is the same number; the
band frequencies and the bank are rounded to float32, as the C stores
them, and used in float64; the outputs are stored as float32 (real,
imaginary) pairs, last axis 2: the check holds the reference of two
batches of the cell in host memory (the rounding is 2^-24 of a value,
under a hundredth of every limit), and the control, put in the program's
place, keeps its imaginary parts through the harness's float32 cast.
The reference proper returns its outputs in host memory; a control
returns them on the input's device, where the program keeps its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import common

CLIPS_PER_BLOCK = 16
FLIP = 1e-5   # a cell differs where it is off by this share of the clip's peak
TWO_PI = 2 * math.pi


def band_frequencies(num: int, bin_per_octave: int, low_fre) -> np.ndarray:
    """(num,) float32 band frequencies, ascending, of the octave scale."""
    bpo = bin_per_octave if 4 <= bin_per_octave <= 48 else 12
    if low_fre is None:
        low_fre = 440.0 * 2.0 ** ((24 - 69) / 12)          # C1, 32.703 Hz
    low = round(bpo * math.log2(np.float32(low_fre) / 440.0))
    notes = np.arange(low, low + num, dtype=np.float64)
    return (2.0 ** (notes / bpo) * 440.0).astype(np.float32)


def morlet_bank(fre: np.ndarray, length: int, samplate: int, gamma: float,
                beta: float) -> np.ndarray:
    """(num, length) morlet bank in the frequency domain, a row a band in
    ``fre``'s order, rounded to float32 (held as float64)."""
    half = length // 2
    w = np.zeros(length)
    w[:half + 1] = np.arange(half + 1) * 2 * np.pi / length
    w[half + 1:] = -w[1:length - half][::-1]
    s = gamma / (fre.astype(np.float64) / samplate * 2 * np.pi)
    x = s[:, None] * w[None, :]
    psi = 2.0 * np.exp(-((x - gamma) ** 2) / beta)
    return np.where(x > 0, psi, 0.0).astype(np.float32).astype(np.float64)


def pad_length(n: int, is_padding: bool) -> int:
    if not is_padding:
        return 0
    return n // 2 if n <= 1e5 else int(math.ceil(math.log2(n)))


class Reference:
    def __init__(self, cfg: dict, device):
        c, s = cfg["plans"]["cwt"], cfg["plans"]["synsq"]
        if c["wavelet"] != "MORLET" or c["scale"] != "OCTAVE":
            raise ValueError("the reference computes the morlet CWT on the "
                             "octave scale only")
        if s["order"] != 1:
            raise ValueError("the reference squeezes at order 1 only")
        self.n = 1 << c["radix2_exp"]
        self.num = c["num"]
        self.samplate = c["samplate"]
        self.pad = pad_length(self.n, c["is_padding"])
        self.fre = band_frequencies(c["num"], c["bin_per_octave"],
                                    c["low_fre"])
        self.bank = torch.from_numpy(morlet_bank(
            self.fre, self.n + 2 * self.pad, c["samplate"], c["gamma"],
            c["beta"]))
        self.thresh = s["thresh"]

    # -- the CWT -----------------------------------------------------------
    def _cwt(self, x, prec):
        q, p = prec.q, self.pad
        if p:
            x = torch.cat([x[..., :p].flip(-1), x, x[..., -p:].flip(-1)], -1)
        spec = q(torch.fft.fft(q(x), dim=-1))
        bank = self.bank.to(x.device, prec.dtype)
        w = q(torch.fft.ifft(q(spec[:, None, :] * bank), dim=-1))
        return w[..., p:p + self.n].contiguous()

    # -- the squeeze -------------------------------------------------------
    def _synsq(self, w, prec):
        q, dt = prec.q, prec.dtype
        phase = q(torch.atan2(w.real, w.imag))
        d = q(phase[..., 1:] - phase[..., :-1])
        sub = d.abs()
        t = torch.floor(sub / TWO_PI)
        t = t + (sub - t * TWO_PI > math.pi).to(dt)
        k = torch.where(sub < math.pi, 0.0, torch.where(d > 0, -t, t))
        e = q(d + k * TWO_PI)
        rate = torch.cat([torch.zeros_like(e[..., :1]), e[..., :-1],
                          e[..., -2:-1]], dim=-1)
        v = q(rate / TWO_PI)
        f = self.fre.astype(np.float64) / self.samplate
        lo, hi = math.log2(f[0]), math.log2(f[self.num - 1])
        fi = torch.floor((torch.log2(v.abs()) - lo) * self.num / (hi - lo)
                         + 0.5)
        power = q(w.real.square() + w.imag.square())
        keep = (fi >= 0) & (fi < self.num) & (power > self.thresh ** 2)
        idx = torch.where(keep, fi, self.num).to(torch.int64)
        planes = torch.view_as_real(w)
        out = torch.zeros(w.shape[:-2] + (self.num + 1,) + w.shape[-1:] + (2,),
                          dtype=dt, device=w.device)
        out.scatter_add_(-3, idx[..., None].expand(planes.shape), planes)
        return q(out[..., :self.num, :, :])

    def run(self, x: torch.Tensor, precision: str = "float64") -> dict:
        """x (clips, n) float32 -> {"cwt", "synsq"}, each (clips, num, n,
        2) float32 pairs; in host memory for float64, else on x's
        device."""
        prec = common.Precision(precision)
        home = torch.device("cpu") if precision == "float64" else x.device
        clips = x.shape[0]
        shape = (clips, self.num, self.n, 2)
        res = {k: torch.empty(shape, dtype=torch.float32, device=home)
               for k in ("cwt", "synsq")}
        for c0 in range(0, clips, CLIPS_PER_BLOCK):
            c1 = min(c0 + CLIPS_PER_BLOCK, clips)
            w = self._cwt(x[c0:c1].to(prec.dtype), prec)
            s = self._synsq(w, prec)
            res["cwt"][c0:c1] = torch.view_as_real(w).to(torch.float32)
            res["synsq"][c0:c1] = s.to(torch.float32)
        return res


def _as_complex(t: torch.Tensor, device) -> torch.Tensor:
    """A block of an output, complex or as (real, imaginary) pairs, as
    complex128 on ``device``."""
    t = t.to(device)
    if not t.is_complex():
        t = torch.view_as_complex(t.to(torch.float32).contiguous())
    return t.to(torch.complex128)


def compare(got: dict, ref: dict) -> dict:
    """The numbers ``correct`` is decided on, over blocks of clips:

    - ``cwt_gap``: the widest, over clips, of max |W - W_ref| / max |W_ref|;
    - ``synsq_flips``: the share of output cells with |S - S_ref| above
      ``FLIP`` of the clip's peak |S_ref| (a cell whose energy moved to
      another bin: ``bench.py``'s gate on the squeeze);
    - ``synsq_mass``: the widest, over clips, of |sum |S| / sum |S_ref| - 1|.
    """
    dev = got["cwt"].device
    clips = got["cwt"].shape[0]
    gap = mass = 0.0
    flips = cells = 0
    for c0 in range(0, clips, CLIPS_PER_BLOCK):
        c1 = min(c0 + CLIPS_PER_BLOCK, clips)
        g, r = (_as_complex(d["cwt"][c0:c1], dev) for d in (got, ref))
        peak = r.abs().flatten(1).amax(1).clamp_min(1e-300)
        gap = max(gap, float(((g - r).abs().flatten(1).amax(1) / peak).max()))
        del g, r
        g, r = (_as_complex(d["synsq"][c0:c1], dev) for d in (got, ref))
        ga, ra = g.abs().flatten(1), r.abs().flatten(1)
        peak = ra.amax(1, keepdim=True)
        flips += int(((g - r).abs().flatten(1) > FLIP * peak).sum())
        cells += ga.numel()
        m = (ga.sum(1) / ra.sum(1).clamp_min(1e-300) - 1).abs()
        mass = max(mass, float(m.max()))
    return {"cwt_gap": gap, "synsq_flips": flips / max(cells, 1),
            "synsq_mass": mass}
