"""Spectral reassignment: the time/frequency corrected STFT.

Counterpart of ``audioflux_tpu/transforms/reassign.py`` (reference
``src/reassign_algorithm.c``): three STFTs with windows h, dh/dn
(wrap-padded central gradient, :initWindowData) and n*h; corrections
w' = w - (sr/2pi)*Im(S_dh/S_h), t' = t + Re(S_th/S_h)/sr
(:_reassignTimeFre), thresholded and clipped to the grid
(:_filterTimeFre), then scatter-added onto (time, fre) bins with a
(-1)^k sign twist (:_rearrage).

The three per-frame FFT loops are one ``ops.fft.rfft`` over a stacked
window tensor, in natural bin order: for a CUDA tensor at pow2
2048 <= n <= 32768 that is the FFT kernel (``ops.cuda_fft.fft_fwd``).  The
scatter is one ``index_add_`` (``ops.scatter.batched_scatter_add``); on the
card its float additions into one bin run in no fixed order, so cells a
rounding away from a bin edge may land in the neighbouring bin.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, f32_scalar, resolve_device
from audioflux_torch.ops.frame import cal_time_length, frame_signal
from audioflux_torch.ops.pad import pad_signal
from audioflux_torch.ops.scatter import batched_scatter_add
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import (PaddingModeType, PaddingPositionType,
                                   ReassignType, WindowType)

__all__ = ["Reassign", "reassign_windows"]


def reassign_windows(window: np.ndarray) -> tuple:
    """(h, dh, th) per reassign_algorithm.c:_reassignObj_initWindowData.

    dh: central gradient of the wrap-padded window; th: n*h with
    n = -N/2 .. N/2-1.
    """
    h = np.asarray(window, np.float32)
    N = h.shape[0]
    pad = np.empty(N + 2, np.float32)
    pad[1:N + 1] = h
    pad[0] = h[N - 1]
    pad[N + 1] = h[0]
    g = np.empty(N + 2, np.float32)
    g[0] = pad[1] - pad[0]
    g[-1] = pad[-1] - pad[-2]
    g[1:-1] = (pad[2:] - pad[:-2]) / 2.0
    dh = g[1:N + 1].copy()
    n = np.arange(-(N // 2), N // 2, dtype=np.float32)
    th = n * h
    return h, dh, th


def _corrections(x, wins, *, fft_length, slide_length, samplate, thresh,
                 re_type, is_padding):
    """The plain STFT and its corrected coordinates: (Sh (..., T, m),
    w2 (..., T, m) Hz, t2 (..., T, m) s, T, tmax), or (Sh, None, None, T,
    None) for ReassignType.NONE.  Any float dtype: a float64 input (and
    float64 windows) gives the float64 coordinates."""
    m = fft_length // 2 + 1
    dev = x.device
    if is_padding:
        x = pad_signal(x, fft_length, slide_length,
                       PaddingPositionType.CENTER, PaddingModeType.CONSTANT,
                       0.0, 0.0)
    frames = frame_signal(x, fft_length, slide_length)  # (..., T, N)
    T = frames.shape[-2]
    rt = ReassignType(re_type)
    # transform only the windows the corrections read: dh feeds the FRE
    # correction, th the TIME one, and at T == 1 the TIME correction is
    # the identity (tmax == 0 clips t2 to 0), so S_th is not needed there
    need_dh = rt in (ReassignType.ALL, ReassignType.FRE)
    need_th = rt in (ReassignType.ALL, ReassignType.TIME) and T > 1
    sel = [0] + ([1] if need_dh else []) + ([2] if need_th else [])
    # a float64 input stays float64 (torch.fft; the kernel tier is fp32)
    S = afft.rfft(frames[..., None, :, :] * wins[sel, None, :], dim=-1,
                  exact=x.dtype == torch.float64)
    Sh = S[..., 0, :, :]                                 # (..., T, m)
    if rt == ReassignType.NONE:
        return Sh, None, None, T, None
    Sdh = S[..., 1, :, :] if need_dh else None
    Sth = S[..., len(sel) - 1, :, :] if need_th else None

    fre = torch.from_numpy(np.linspace(0.0, samplate / 2.0, m)
                           .astype(np.float32)).to(dev)
    # true fp32 divisions on both devices, as the reference's
    sr = f32_scalar(samplate, dev)
    tim = (torch.arange(T, dtype=torch.float32, device=dev)
           * slide_length) / sr
    timb = tim[:, None]
    power = Sh.real.square() + Sh.imag.square()
    th32 = np.float32(thresh)
    good = power >= float(th32 * th32)
    denom = torch.where(Sh.abs() == 0, torch.ones_like(Sh), Sh)
    fmax = samplate / 2.0
    tmax = tim[-1]

    if need_dh:
        w2 = fre + (Sdh / denom).imag * np.float32(-0.5 * samplate / np.pi)
        w2 = torch.clamp(torch.where(good, w2, fre), 0.0, fmax)
    else:
        w2 = fre.expand(Sh.shape)
    if need_th:
        t2 = timb + (Sth / denom).real / sr
        t2 = torch.where(good, t2, timb.expand(Sh.shape))
        t2 = torch.minimum(torch.clamp(t2, min=0.0), tmax)
    else:
        t2 = timb.expand(Sh.shape)
    return Sh, w2, t2, T, tmax


def _frequency_position(x, wins, *, fft_length, slide_length, samplate,
                        thresh, re_type, is_padding):
    """The reassigned frequency of every STFT cell on the bin grid, before
    rounding: (..., T, m), bin ``floor(p + 0.5)``; a cell whose p lies a
    rounding away from a half-integer (a bin edge) may land in either bin.
    The plain STFT's power beside it (thresholded at ``thresh**2``)."""
    Sh, w2, _, _, _ = _corrections(
        x, wins, fft_length=fft_length, slide_length=slide_length,
        samplate=samplate, thresh=thresh, re_type=re_type,
        is_padding=is_padding)
    fmax = samplate / 2.0
    return (w2 * (fft_length // 2) / f32_scalar(fmax, x.device),
            Sh.real.square() + Sh.imag.square())


def _reassign_impl(x, wins, *, fft_length, slide_length, samplate, thresh,
                   re_type, order, result_type, is_padding):
    """(..., n) -> (reassigned (..., m, T), plain STFT (..., m, T))."""
    m = fft_length // 2 + 1
    dev = x.device
    Sh, w2, t2, T, tmax = _corrections(
        x, wins, fft_length=fft_length, slide_length=slide_length,
        samplate=samplate, thresh=thresh, re_type=re_type,
        is_padding=is_padding)
    if w2 is None:
        out = Sh.transpose(-1, -2)
        return out, out
    fmax = samplate / 2.0

    # grid indices (roundf == floor(x + 0.5) for non-negative values)
    if T > 1:
        ti = torch.floor(t2 * (T - 1) / tmax + 0.5).to(torch.int32)
    else:
        ti = torch.zeros(Sh.shape, dtype=torch.int32, device=dev)
    fi = torch.floor(w2 * (fft_length // 2) / f32_scalar(fmax, dev)
                     + 0.5).to(torch.int32)

    # order > 1: the composition fi <- fi[fi] along the frequency axis
    # (reassign_algorithm.c:_rearrage order loop)
    for _ in range(max(order, 1) - 1):
        valid = (fi >= 0) & (fi < m)
        gathered = torch.gather(fi, -1, fi.clamp(0, m - 1).to(torch.int64))
        fi = torch.where(valid, gathered, torch.zeros_like(fi))

    sign = torch.where(torch.arange(m, device=dev) % 2 == 1, -1.0, 1.0)
    vals = Sh * sign
    in_range = (ti >= 0) & (ti < T) & (fi >= 0) & (fi < m)
    flat_idx = torch.where(in_range, ti * m + fi,
                           torch.full_like(ti, T * m))     # T*m drops
    lead = vals.shape[:-2]
    v = vals if result_type == 0 else vals.abs()
    out = batched_scatter_add(v.reshape(lead + (T * m,)),
                              flat_idx.reshape(lead + (T * m,)), T * m)
    out = out.reshape(lead + (T, m))
    if result_type != 0:
        out = out.to(torch.complex64)
    return out.transpose(-1, -2), Sh.transpose(-1, -2)


class Reassign:
    """API mirrors ``python/audioflux/reassign.py``, plus ``device``
    (``None`` means ``cuda``).

    ``reassign(x)`` returns the reassigned spectrogram (..., fre, time):
    complex (result_type 0) or the scatter of |S_h| as real (result_type 1).
    """

    def __init__(self, radix2_exp: int = 12, samplate: int = 32000,
                 window_type: WindowType = WindowType.HANN,
                 slide_length: int = None,
                 re_type: ReassignType = ReassignType.ALL,
                 thresh: float = 0.001,
                 is_padding: bool = False, device=None):
        if not 1 < radix2_exp < 31:
            raise ValueError("radix2_exp must be in [2, 30]")
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.fft_length = 1 << radix2_exp
        self.window_type = WindowType(window_type)
        self.slide_length = (slide_length if slide_length
                             else self.fft_length // 4)
        self.re_type = ReassignType(re_type)
        self.thresh = float(thresh)
        self.is_padding = bool(is_padding)
        self.result_type = 0
        self.order = 1

        h, dh, th = reassign_windows(
            get_fft_window(self.window_type, self.fft_length))
        self._wins = np.stack([h, dh, th])
        self._build_exec()

    def _build_exec(self):
        """Upload the three windows to the plan's device."""
        self._wins_t = as_tensor(self._wins, self.device)

    def set_result_type(self, result_type: int):
        """0: complex matrix, 1: real (reassign.py:148)."""
        self.result_type = int(result_type)

    def set_order(self, order: int):
        if order >= 1:
            self.order = int(order)

    def cal_time_length(self, data_length: int) -> int:
        n = data_length
        if self.is_padding:
            n += self.fft_length  # center pad fft/2 each side
        return cal_time_length(n, self.fft_length, self.slide_length)

    def reassign(self, data_arr, result_type: int = None,
                 with_stft: bool = False):
        """Reassigned matrix; ``result_type`` overrides the instance's
        (0 complex / 1 real, reassign.py:177); ``with_stft`` also returns
        the plain STFT (an extension)."""
        rt = self.result_type if result_type is None else int(result_type)
        out, stft = _reassign_impl(
            as_tensor(data_arr, self.device), self._wins_t,
            fft_length=self.fft_length, slide_length=self.slide_length,
            samplate=self.samplate, thresh=self.thresh,
            re_type=int(self.re_type), order=self.order,
            result_type=rt, is_padding=self.is_padding)
        if rt == 1:
            out = out.real
        return (out, stft) if with_stft else out

    def y_coords(self):
        return np.linspace(0, self.samplate / 2, self.fft_length // 2 + 1)

    def x_coords(self, data_length: int):
        T = self.cal_time_length(data_length)
        return np.arange(T) * self.slide_length / self.samplate
