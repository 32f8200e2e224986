"""Plain reference of ``mir_pipeline_32k``: YIN pitch, the mel spectral
flux envelope, its onset points, and the median-filter HPSS, for
recordings (rows, n).

- YIN (``_pitch_yin.c``): per frame the difference function from the
  autocorrelation at lags ``auto_length ..`` (a circular correlation
  with the frame's reversed prefix, no aliasing in the taken range) and
  the sliding energies, values under 1e-6 set to 0; the cumulative-mean-
  normalised difference; the first trough under the threshold, refined by
  a parabola; 0 where there is none.
- Flux (``flux_spectral.c``): the power mel spectrogram (periodic Hann,
  slaney triangles), then per frame ``sum(max(x_t - x_{t-step}, 0) ** p)``,
  the first ``step`` frames 0.
- Onsets (``onset_algorithm.c``): the envelope shifted to a minimum of 0
  and scaled to a maximum of 1, then a frame is a point where it is the
  largest of ``[i - pre_max, i + post_max - 1]``, at least ``delta`` above
  the mean of ``[i - pre_avg, i + post_avg - 1]`` (both clamped to the
  envelope), and more than ``wait`` frames after the last point.
- HPSS (``hpss_algorithm.c``): the magnitude STFT (periodic Hamming), the
  median over ``h_order`` frames and over ``p_order`` bins (zero padding),
  Wiener masks ``h^2 / (h^2 + p^2)`` and ``p^2 / (h^2 + p^2)`` on the
  complex spectrum, each inverted and overlap-added with the window,
  divided by the overlap-added squared window (where that is under 1e-6,
  by 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import common

FRAMES_PER_BLOCK = 4096


class Reference:
    def __init__(self, cfg: dict, device):
        p = cfg["plans"]
        self.device = torch.device(device)
        y = p["yin"]
        self.y_n = 1 << y["radix2_exp"]
        self.y_slide = y["slide_length"]
        self.y_auto = y["auto_length"]
        self.y_sr = float(y["samplate"])
        self.y_min = int(math.floor(y["samplate"] / y["high_fre"]))
        self.y_max = min(int(math.ceil(y["samplate"] / y["low_fre"])),
                         self.y_n - self.y_auto - 1)
        self.y_thresh = y["thresh"]
        m = p["mel"]
        self.m_n = 1 << m["radix2_exp"]
        self.m_slide = m["slide_length"]
        self.m_win = torch.from_numpy(common.fft_window("hann", self.m_n))
        self.m_bank = torch.from_numpy(common.mel_filter_bank(
            m["num"], self.m_n, m["samplate"])).double()
        self.flux = p["flux"]
        o = p["onset"]
        sr, sl = o["samplate"], o["slide_length"]
        self.pre_max = int(math.floor(0.03 * sr / sl))
        self.post_max = int(math.floor(0.0 * sr / sl + 1))
        self.pre_avg = int(math.floor(0.1 * sr / sl))
        self.post_avg = int(math.floor(0.1 * sr / sl + 1))
        self.wait = int(math.floor(0.03 * sr / sl))
        self.delta = 0.07
        h = p["hpss"]
        self.h_n = 1 << h["radix2_exp"]
        self.h_slide = h["slide_length"]
        self.h_win = torch.from_numpy(common.fft_window("hamm", self.h_n))
        self.h_order, self.p_order = h["h_order"], h["p_order"]

    # -- YIN ---------------------------------------------------------------
    def _diff(self, fr, prec):
        """YIN's difference function of frames (T, n) at lags 0 ..
        n - auto_length - 1."""
        q = prec.q
        n, auto = self.y_n, self.y_auto
        rev = F.pad(fr[:, :auto + 1].flip(-1), (0, n - auto - 1))
        prod = q(q(torch.fft.rfft(fr, dim=-1)) * q(torch.fft.rfft(rev, dim=-1)))
        acf = q(torch.fft.irfft(prod, n=n, dim=-1)[:, auto:])
        acf = torch.where(acf.abs() >= 1e-6, acf, 0.0)
        csum = q(torch.cumsum(q(fr * fr), dim=-1))
        e2 = q(csum[:, auto:] - csum[:, :n - auto])
        e2 = torch.where(e2.abs() >= 1e-6, e2, 0.0)
        return q(e2[:, :1] + e2 - 2.0 * acf)

    def _yin(self, x, prec):
        q, dt = prec.q, prec.dtype
        fr = q(common.frames(x.to(dt), self.y_n, self.y_slide))
        lo = self.y_min
        cm = self._cmnd_of(self._diff(fr, prec), prec)
        v1, v2, v3 = cm[:, :-2], cm[:, 1:-1], cm[:, 2:]
        off = q(-(v3 - v1) / 2.0 / (2.0 * ((v1 + v3 - 2 * v2) / 2.0) + 1e-16))
        off = F.pad(torch.where(off.abs() <= 1.0, off, 0.0), (1, 1))
        below = cm < self.y_thresh
        trough = torch.zeros_like(below)
        trough[:, 0] = (cm[:, 0] < cm[:, 1]) & below[:, 0]
        trough[:, 1:-1] = ((cm[:, 1:-1] <= cm[:, 2:]) & (cm[:, 1:-1] < cm[:, :-2])
                           & below[:, 1:-1])
        found = trough.any(dim=-1)
        first = torch.argmax(trough.to(torch.uint8), dim=-1)
        o = off.gather(1, first[:, None])[:, 0]
        fre = self.y_sr / (lo + first.to(dt) + o)
        return torch.where(found, fre, 0.0)

    def _cmnd_of(self, d, prec):
        """The cumulative-mean-normalised difference at lags min..max of
        difference functions ``d`` (frames, lags)."""
        lo, hi, q = self.y_min, self.y_max, prec.q
        mean = q(torch.cumsum(d[:, 1:hi + 1], dim=-1)
                 / torch.arange(1, hi + 1, dtype=d.dtype, device=d.device))
        return q(d[:, lo:hi + 1] / (mean[:, lo - 1:hi] + 1e-16))

    def _cmnd(self, frame):
        """The float64 CMND of one frame."""
        prec = common.Precision("float64")
        return self._cmnd_of(self._diff(frame[None], prec), prec)[0]

    # -- mel flux ----------------------------------------------------------
    def _flux(self, x, prec):
        q, dt = prec.q, prec.dtype
        fr = q(q(common.frames(x.to(dt), self.m_n, self.m_slide))
               * self.m_win.to(x.device, dt))
        spec = q(torch.fft.rfft(fr, dim=-1))
        power = q(spec.real.square() + spec.imag.square())
        mel = prec.matmul(power, self.m_bank.to(x.device, dt).T.contiguous())
        f = self.flux
        step = max(int(f["step"]), 1)
        d = q(mel[step:] - mel[:-step])
        d = d.clamp_min(0.0) if f["is_positive"] else d.abs()
        v = q(d.pow(f["p"]).sum(dim=-1))
        if f["tp"]:
            v = v / mel.shape[-1]
        if f["is_exp"]:
            v = v.pow(1.0 / f["p"])
        return F.pad(v, (step, 0))

    # -- onsets ------------------------------------------------------------
    def onset_points(self, env: np.ndarray) -> np.ndarray:
        e = np.asarray(env, np.float64)
        e = e - e.min()
        if e.max() > 0:
            e = e / e.max()
        n = len(e)
        pts, last = [], None
        for i in range(n):
            s1, e1 = max(i - self.pre_max, 0), min(i + self.post_max - 1, n - 1)
            if e[i] < e[s1:e1 + 1].max():
                continue
            s2, e2 = max(i - self.pre_avg, 0), min(i + self.post_avg - 1, n - 1)
            if e[i] < e[s2:e2 + 1].mean() + self.delta:
                continue
            if last is None or i - last > self.wait:
                pts.append(i)
                last = i
        return np.asarray(pts, np.int64)

    # -- HPSS --------------------------------------------------------------
    def _median(self, mag, order, dim):
        """Median of ``order`` values along ``dim`` with order // 2 zeros
        of padding each side, in blocks of frames."""
        half = order // 2
        t = mag.shape[0]
        out = torch.empty_like(mag)
        if dim == 0:
            padded = F.pad(mag.T, (half, half)).T
            for s, e in common.frame_blocks(t, FRAMES_PER_BLOCK):
                w = padded[s:e + 2 * half].unfold(0, order, 1)
                out[s:e] = w.median(dim=-1).values
        else:
            padded = F.pad(mag, (half, half))
            for s, e in common.frame_blocks(t, FRAMES_PER_BLOCK):
                out[s:e] = padded[s:e].unfold(1, order, 1).median(dim=-1).values
        return out

    def _hpss(self, x, prec):
        q, dt = prec.q, prec.dtype
        win = self.h_win.to(x.device, dt)
        fr = q(q(common.frames(x.to(dt), self.h_n, self.h_slide)) * win)
        spec = q(torch.fft.rfft(fr, dim=-1))
        mag = q(spec.abs())
        h = self._median(mag, self.h_order, 0)
        p = self._median(mag, self.p_order, 1)
        h2, p2 = q(h * h), q(p * p)
        den = q(torch.clamp(h2 + p2, min=1e-16))
        norm = common.overlap_add(
            (win * win).expand(fr.shape[0], -1).contiguous(), self.h_slide)
        norm = torch.where(norm < 1e-6, 1.0, norm)
        out = []
        for mask in (q(h2 / den), q(p2 / den)):
            y = q(torch.fft.irfft(q(mask * spec), n=self.h_n, dim=-1)) * win
            out.append(q(common.overlap_add(q(y), self.h_slide) / norm))
        return out

    def run(self, x: torch.Tensor, precision: str = "float64") -> dict:
        """x (rows, n) float32 -> {"pitch", "env", "points", "h", "p"}."""
        prec = common.Precision(precision)
        res = {"pitch": [], "env": [], "points": [], "h": [], "p": []}
        for r in range(x.shape[0]):
            xr = x[r]
            res["pitch"].append(self._yin(xr, prec))
            env = self._flux(xr, prec)
            res["env"].append(env)
            res["points"].append(self.onset_points(env.double().cpu().numpy()))
            h, p = self._hpss(xr, prec)
            res["h"].append(h)
            res["p"].append(p)
        return {k: (v if k == "points" else torch.stack(v))
                for k, v in res.items()}


FLIP = 0.01


def _pitch_rel(got, ref):
    """Per frame |f - f_ref| / max(f, f_ref); 0 where both are 0, 1 where
    one found a trough and the other none."""
    g, r = got.double().reshape(-1), ref.double().reshape(-1)
    top = torch.maximum(g.abs(), r.abs())
    return torch.where(top > 0, (g - r).abs() / top.clamp_min(1e-300), 0.0)


def pitch_flips(got, ref) -> float:
    """Share of frames whose pitch is off the reference's by more than a
    hundredth: a trough that moved, or one found where the other found
    none."""
    return float((_pitch_rel(got, ref) > FLIP).double().mean())


def pitch_gap(got, ref) -> float:
    """Mean relative gap over the frames that agree within a hundredth."""
    rel = _pitch_rel(got, ref)
    keep = rel <= FLIP
    return float(rel[keep].mean()) if bool(keep.any()) else 1.0


def onset_share(got, ref) -> float:
    """Points in one list and not the other, over the reference's points."""
    diff = total = 0
    for g, r in zip(got, ref):
        g, r = set(np.asarray(g).tolist()), set(np.asarray(r).tolist())
        diff += len(g ^ r)
        total += len(r)
    return diff / max(total, 1)


def explain(got: dict, x: torch.Tensor, ref_obj: "Reference", limit: int = 5):
    """The frames whose pitch flipped against the float64 reference: for
    each, the reference's CMND at the trough it picked and at the one the
    program's pitch points to, beside the threshold."""
    ref = torch.stack([ref_obj._yin(x[r], common.Precision("float64"))
                       for r in range(x.shape[0])])
    rel = _pitch_rel(got["pitch"], ref).reshape(ref.shape)
    out = []
    for r, t in (rel > FLIP).nonzero().tolist()[:limit]:
        n, sl = ref_obj.y_n, ref_obj.y_slide
        cm = ref_obj._cmnd(x[r, t * sl:t * sl + n].double())
        lo = ref_obj.y_min
        pick = lambda f: (int(round(ref_obj.y_sr / f)) - lo) if f > 0 else None
        fg, fr = float(got["pitch"][r, t]), float(ref[r, t])
        at = lambda k: None if k is None or not 0 <= k < len(cm) else float(cm[k])
        out.append({"row": r, "frame": t, "program_hz": fg, "reference_hz": fr,
                    "cmnd_at_program": at(pick(fg)),
                    "cmnd_at_reference": at(pick(fr)),
                    "cmnd_min": float(cm.min()), "thresh": ref_obj.y_thresh})
    return out


def compare(got: dict, ref: dict) -> dict:
    """The numbers ``correct`` is decided on."""
    return {"pitch_flips": pitch_flips(got["pitch"], ref["pitch"]),
            "pitch_gap": pitch_gap(got["pitch"], ref["pitch"]),
            "flux_gap": common.peak_share(got["env"], ref["env"]),
            "onset_share": onset_share(got["points"], ref["points"]),
            "harmonic_gap": common.peak_share(got["h"], ref["h"]),
            "percussive_gap": common.peak_share(got["p"], ref["p"])}
