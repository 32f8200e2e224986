"""Plain reference of ``cqt_chroma_32k``: the constant-Q transform of
clips of n samples and its chroma, for (clips, n) audio.  The CQT comes
out as (clips, num, T, 2) real pairs (real, imaginary), rows ascending in
frequency; the chroma as (clips, chroma_num, T); T = n // slide + 1.

- Band frequencies (``cqt_filterBank.c`` ``cqt_calFreArr``): octave o
  starts at ``low_fre 2^o`` rounded to float32, and each next band is the
  one before times ``2^(1 / bpo)``, in float32.
- Lengths: ``Q sr / (f + beta / v)`` with ``v = 2^(1 / bpo) - 1`` and ``Q
  = factor / v``, stored as float32; the transform's length is the power
  of two at or above the top octave's first length rounded up, the slide
  a quarter of it by default.
- Kernels (``cqt_filterBank.c:246-389``), one a band of the top octave:
  the periodic Hann window of ``L = ceil(len)`` samples (RECT is taken as
  HANN) times ``exp(2 pi i m f / sr)``, over the window's sum (AREA),
  times ``len / fft_length``, centred at ``(fft_length - L) // 2`` of a
  row of ``fft_length`` zeros; its full FFT's first ``fft_length / 2 +
  1`` bins, each zeroed unless ``|K|^2 > thresh^2``.
- The octave chain (``cqt_algorithm.c:993-1000``, Brown and Puckette):
  the top octave from the audio; each lower octave from the audio
  resampled 2:1 once more, at half the slide, through the same top
  kernel (at a halved rate both the phase f / sr and the length are the
  top octave's).
- The 2:1 resampler (``resample_algorithm.c``, FAST): a right-half
  windowed-sinc table of ``zero_num 2^nbit + 1`` points, ``roll_off
  sinc(roll_off t)`` for t from 0 to ``zero_num`` times the right half of
  a symmetric Kaiser window of twice its length less one (beta, the
  C's 15-term Bessel series), times the ratio 1/2; output i at input time
  ``t = 2 i``: the table read every ``2^nbit / 2`` points, linearly
  interpolated, from the phase ``t - floor(t)`` for the samples at and
  before ``floor(t)`` and from ``1/2`` less it for those after; samples
  outside the signal are 0; ``floor(n / 2)`` outputs, over
  ``sqrt(1/2)`` (``is_scale``).
- Each octave's frames: the tail ``n % slide`` dropped, ``fft_length /
  2`` zeros on each side, rect frames every ``slide`` samples, their
  real FFT times the kernel's conjugate-free product ``S K^T``; an octave
  with fewer frames than T is padded with zero frames.
- The scale (``is_scale``): band b of the octave resampled d times, times
  ``sqrt(2^d) / sqrt(len_b)``.
- Chroma (``chroma_filterBank.c`` ``chroma_cqtFilterBank``,
  ``cqt_algorithm.c`` ``cqtObj_chroma``): the power ``|C|^2`` folded by a
  0/1 bank (chroma bin 0 the ``ceil(k / 2)`` lowest of each octave's
  groups of ``k = bpo / chroma_num`` bins and the ``k - ceil(k / 2)``
  highest, each next bin the next group), its rows rotated by the tonic
  of ``low_fre`` (the MIDI note mod 12, folded to 12 less it above 6,
  times ``chroma_num // bpo``); each frame over its largest magnitude
  (MAX), a frame of zeros kept.

Departures from the C: every sum, transform and product is in float64
(the C's are float32); the kernels and the resampler's taps are
rounded to float32, as the C stores them, and used in float64; the
scale is computed in float64 from the float32 lengths; the resampler's
phase is exact (the C's float32 ``i / ratio`` is exact at 2:1 for fewer
than 2^23 outputs, so nothing is departed from at the cell's size).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import common

CLIPS_PER_BLOCK = 16
ROWS_PER_COMPARE = 8
RESAMPLE = {"zero_num": 16, "nbit": 9, "beta": 8.5555046, "roll_off": 0.85}


def c1() -> float:
    """C1 (MIDI 24), the default lowest band."""
    return 440.0 * 2.0 ** ((24 - 69) / 12.0)


def band_frequencies(low: float, num: int, bpo: int) -> np.ndarray:
    """The ``num`` band frequencies (float32, as the C computes them)."""
    f32 = np.float32
    step = f32(2.0 ** (1.0 / bpo))
    out = np.empty(num, np.float32)
    for o in range(num // bpo):
        f = f32(low * 2 ** o)
        out[o * bpo] = f
        for j in range(1, bpo):
            f = f32(f * step)
            out[o * bpo + j] = f
    return out


class Plan:
    """The sizes, kernels, taps, scale and chroma bank of a plan."""

    def __init__(self, c: dict, h: dict):
        self.num, self.bpo = c["num"], c["bin_per_octave"]
        self.sr = c["samplate"]
        self.octaves = self.num // self.bpo
        low = c1() if c["low_fre"] is None else float(c["low_fre"])
        self.fre = band_frequencies(low, self.num, self.bpo)
        v = 2.0 ** (1.0 / self.bpo) - 1.0
        q = c["factor"] / v
        self.lengths = (q * self.sr / (self.fre.astype(np.float64)
                                       + c["beta"] / v)).astype(np.float32)
        top = (self.octaves - 1) * self.bpo
        top_len = math.ceil(q * self.sr / (float(self.fre[top])
                                           + c["beta"] / v))
        self.fft_length = 1 << (top_len - 1).bit_length()
        self.slide = c["slide_length"] or self.fft_length // 4
        self.kernel = kernels(self.fre[top:], self.lengths[top:], self.sr,
                              self.fft_length, c["thresh"])
        self.left, self.right = halfband_taps(**RESAMPLE)
        d = np.repeat(np.arange(self.octaves - 1, -1, -1), self.bpo)
        self.scale = np.sqrt(2.0 ** d)
        if c["is_scale"]:
            self.scale = self.scale / np.sqrt(self.lengths.astype(np.float64))
        self.chroma = chroma_bank(h["chroma_num"], self.num, self.bpo, low)
        if (h["data_type"], h["norm_type"]) != ("POWER", "MAX"):
            raise ValueError("the reference folds the power over its MAX")


def kernels(fre, lengths, sr: int, fft_length: int, thresh: float):
    """(bands, fft_length / 2 + 1) complex kernels, float32 as stored."""
    rows = np.zeros((len(fre), fft_length), np.complex128)
    for i, (f, ln) in enumerate(zip(fre, lengths)):
        ln = float(ln)
        size = math.ceil(ln)
        w = common.fft_window("hann", size)
        m = np.arange(size)
        k = w * np.exp(2j * np.pi * m * float(f) / sr)
        k = k / w.sum() * (ln / fft_length)
        start = (fft_length - size) // 2
        rows[i, start:start + size] = k
    spec = np.fft.fft(rows, axis=-1)[:, :fft_length // 2 + 1]
    spec = np.where(np.abs(spec) ** 2 > thresh * thresh, spec, 0)
    return spec.astype(np.complex64).astype(np.complex128)


def _bessel_i0(x):
    """The C's zeroth-order modified Bessel function: 15 terms of its
    series."""
    total, term = np.ones_like(x), np.ones_like(x)
    for k in range(1, 16):
        term = term * (x / 2.0) / k
        total = total + term * term
    return total


def halfband_taps(zero_num: int, nbit: int, beta: float, roll_off: float):
    """The 2:1 resampler's taps, float32 as stored: (left, right), left[j]
    weighting the sample j before an output's input time and right[j]
    the sample j + 1 after it."""
    bits = 1 << nbit
    points = zero_num * bits + 1
    t = np.linspace(0.0, zero_num, points)
    half = np.arange(points - 1, 2 * points - 1)
    span = 2 * (points - 1)
    kaiser = _bessel_i0(beta * np.sqrt(np.maximum(
        1.0 - (2.0 * half / span - 1.0) ** 2, 0.0))) / _bessel_i0(
            np.float64(beta))
    ratio = 0.5
    table = roll_off * np.sinc(roll_off * t) * kaiser * ratio
    delta = np.append(np.diff(table), 0.0)
    step = int(ratio * bits)
    phase = 0.0        # the input time 2 i is a whole sample

    def read(frac):
        at = frac * ratio * bits
        off = int(math.floor(at))
        eta = at - off
        idx = off + step * np.arange((points - off) // step)
        return table[idx] + eta * delta[idx]

    return (read(phase).astype(np.float32).astype(np.float64),
            read(1.0 - phase).astype(np.float32).astype(np.float64))


def chroma_bank(chroma_num: int, num: int, bpo: int, low: float):
    """(chroma_num, num) 0/1 fold with the tonic rotation."""
    k = bpo // chroma_num
    lo = math.ceil(k / 2.0)
    hi = k - lo
    bank = np.zeros((chroma_num, num))
    pos = np.arange(num) % bpo
    bank[0, pos < lo] = 1.0
    if hi:
        bank[0, pos >= bpo - hi] = 1.0
    for i in range(1, chroma_num):
        start = lo + (i - 1) * k
        bank[i, (pos >= start) & (pos < start + k)] = 1.0
    tonic = int(round(12 * math.log2(low / 440.0) + 69)) % 12
    if tonic > 6:
        tonic = 12 - tonic
    return np.roll(bank, -tonic * (chroma_num // bpo), axis=0)


class Reference:
    def __init__(self, cfg: dict, device):
        # float32 products stay float32, as the configuration states
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.plan = Plan(cfg["plans"]["cqt"], cfg["plans"]["chroma"])

    @staticmethod
    def _t(a, x, prec):
        """numpy ``a`` on ``x``'s device in the precision's dtype."""
        return torch.as_tensor(a, device=x.device).to(prec.dtype)

    def _resample(self, x, prec):
        """(rows, n) -> (rows, n // 2): the 2:1 resampler."""
        p = self.plan
        left, right = self._t(p.left, x, prec), self._t(p.right, x, prec)
        if prec.name == "tf32":       # the taps' product's operands
            x, left, right = map(common.round_tf32, (x, left, right))
        out = x.shape[-1] // 2
        a, b = len(p.left), len(p.right)
        xp = torch.nn.functional.pad(x, (a - 1, b))
        y = torch.zeros(x.shape[0], out, dtype=x.dtype, device=x.device)
        for j in range(a):           # sample 2 i - j
            y += left[j] * xp[:, a - 1 - j:a - 1 - j + 2 * out:2]
        for j in range(b):           # sample 2 i + 1 + j
            y += right[j] * xp[:, a + j:a + j + 2 * out:2]
        return prec.q(y * math.sqrt(2.0))

    def _octave(self, x, slide, t, prec):
        """(rows, n) -> (rows, t, bpo): the octave's frames times the
        kernel."""
        p = self.plan
        n = x.shape[-1] - x.shape[-1] % slide
        half = p.fft_length // 2
        xp = torch.nn.functional.pad(x[:, :n],
                                     (half, p.fft_length - half))
        frames = xp.unfold(-1, p.fft_length, slide)[:, :t]
        spec = prec.q(torch.fft.rfft(frames, dim=-1))
        kr = self._t(p.kernel.real, x, prec)
        ki = self._t(p.kernel.imag, x, prec)
        sr, si = spec.real.contiguous(), spec.imag.contiguous()
        re = prec.q(prec.matmul(sr, kr.T) - prec.matmul(si, ki.T))
        im = prec.q(prec.matmul(si, kr.T) + prec.matmul(sr, ki.T))
        out = torch.zeros(x.shape[0], t, p.bpo, 2, dtype=x.dtype,
                          device=x.device)
        got = re.shape[1]
        out[:, :got, :, 0], out[:, :got, :, 1] = re, im
        return out

    def _cqt(self, x, prec):
        """(rows, n) -> (rows, num, t, 2)."""
        p = self.plan
        t = x.shape[-1] // p.slide + 1
        slide = p.slide
        blocks = [None] * p.octaves
        for i in range(p.octaves - 1, -1, -1):
            blocks[i] = self._octave(x, slide, t, prec)
            if i:
                x = self._resample(x, prec)
                slide //= 2
        scale = self._t(p.scale, x, prec)
        out = prec.q(torch.cat(blocks, dim=2) * scale[:, None])
        return out.permute(0, 2, 1, 3)

    def _chroma(self, c, prec):
        """(rows, num, t, 2) -> (rows, chroma_num, t)."""
        p = self.plan
        power = prec.q(c[..., 0] ** 2 + c[..., 1] ** 2).transpose(1, 2)
        bank = self._t(p.chroma, c, prec)
        fold = prec.q(prec.matmul(power, bank.T))
        top = fold.abs().amax(dim=-1, keepdim=True)
        fold = prec.q(torch.where(top != 0, fold / top, fold))
        return fold.transpose(1, 2)

    def run(self, x: torch.Tensor, precision: str = "float64") -> dict:
        """x (rows, n) float32 -> {"cqt": (rows, num, T, 2), "chroma":
        (rows, chroma_num, T)} on x's device: float64 for the reference
        proper, float32 else."""
        prec = common.Precision(precision)
        rows, n = x.shape
        p = self.plan
        t = n // p.slide + 1
        res = {"cqt": torch.empty(rows, p.num, t, 2, dtype=prec.dtype,
                                  device=x.device),
               "chroma": torch.empty(rows, p.chroma.shape[0], t,
                                     dtype=prec.dtype, device=x.device)}
        for r0 in range(0, rows, CLIPS_PER_BLOCK):
            xb = prec.q(x[r0:r0 + CLIPS_PER_BLOCK].to(prec.dtype))
            c = self._cqt(xb, prec)
            res["cqt"][r0:r0 + len(xb)] = c
            res["chroma"][r0:r0 + len(xb)] = self._chroma(c, prec)
            del c
        return res


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``common.peak_share`` a few rows at a time."""
    return max(common.peak_share(got[r:r + ROWS_PER_COMPARE],
                                 ref[r:r + ROWS_PER_COMPARE])
               for r in range(0, got.shape[0], ROWS_PER_COMPARE))


def compare(got: dict, ref: dict) -> dict:
    """The numbers ``correct`` is decided on:

    - ``cqt_gap``: the widest over clips of ``max |C - ref| / max |ref|``
      over the CQT's real pairs;
    - ``chroma_gap``: the same for the chroma.
    """
    return {"cqt_gap": _gap(got["cqt"], ref["cqt"]),
            "chroma_gap": _gap(got["chroma"], ref["chroma"])}
