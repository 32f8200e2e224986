"""PEF from the recordings to the pitch in two kernels (``csrc/pef.cu``),
and their plain PyTorch versions.

``PitchPEF`` takes each frame's power spectrum at 2 N, resamples it onto
a log grid of 2 N points, cross-correlates that row (placed at
``pad_num`` in X zeros) with its comb filter at X points and keeps the
lag of the largest value.  The two kernels split that at the log grid:

* :func:`pef_log_power` (``pef_log_power_kernel``): each frame read from
  its recording with the window applied in the load, the real-row
  forward at 2 N in registers, the power of the linear bins the grid
  reads, and the frame's grid row, (p[pos] + w (p[pos + 1] - p[pos])) bw,
  written as one float32 row;
* :func:`pef_xcorr_pitch` (``pef_xcorr_pitch_kernel``): each row's
  forward at X, the product with conj(Ff) and the half-spectrum merge of
  the inverse in registers, the inverse's passes in the opposite order,
  and the arg-max over the lags in the block; one float a frame out,
  ``log_fre[lag]``.

Neither replaces a TPU kernel (the JAX package's PEF is XLA code around
its FFT kernels).  The front's values are the plain version's on the
card, bit for bit (the same transform, split and roundings); the back's
product and merge round in another order than the plain path's, so a
frame whose two largest lags lie within float32 rounding of each other
(the peak is flat on the fine log grid) may pick the other one.

:func:`supports` says which calls take them: a CUDA float32 input at
``fft_length`` 4096 and ``xcorr_length`` 32768.  ``PitchPEF.pitch``
routes by it; every other call keeps ``PitchPEF._pef_impl``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audioflux_torch.observe import scope, setup_table
from audioflux_torch.ops import _build, cuda_fft
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.frame import cal_time_length, frame_signal

__all__ = ["FFT_LENGTH", "XCORR_LENGTH", "supports", "pef_log_power",
           "pef_log_power_ref", "pef_xcorr_pitch", "pef_xcorr_pitch_ref"]

FFT_LENGTH = 4096       # the frame length the kernels take (front n = 8192)
XCORR_LENGTH = 32768    # the cross-correlation's length they take
GRID_MAX = 8192         # the back stages a row of at most this many points
LIVE_END = 12288        # ... which ends by this point of its zero row


def supports(x, fft_length: int, xcorr_length: int) -> bool:
    """Whether the kernels take PEF of ``x``: a CUDA float32 tensor,
    ``fft_length`` 4096 and ``xcorr_length`` 32768."""
    return (x.is_cuda and x.dtype == torch.float32
            and fft_length == FFT_LENGTH and xcorr_length == XCORR_LENGTH)


@functools.lru_cache(maxsize=None)
@setup_table
def _lib():
    lib = _build.load("pef")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.af_pef_log_power.argtypes = [p, p, p, p, p, p, p, ll, ll, i, i, i, i,
                                     i, i, p]
    lib.af_pef_xcorr_pitch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
    for fn in (lib.af_pef_log_power, lib.af_pef_xcorr_pitch):
        fn.restype = ctypes.c_int
    return lib


def _check_f32(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def pef_log_power_ref(x, window, pos, w, band_width, *, fft_length: int,
                      slide_length: int) -> torch.Tensor:
    """Plain version of :func:`pef_log_power`: the windowed frames, their
    ``rfft`` at 2 fft_length, the power, and the log grid's
    interpolation."""
    frames = frame_signal(x, fft_length, slide_length) * window
    Fs = afft.rfft(frames, n=2 * fft_length, dim=-1)
    power = Fs.real ** 2 + Fs.imag ** 2
    del Fs
    p1 = power[..., pos]
    p2 = power[..., pos + 1]
    return (p1 + w * (p2 - p1)) * band_width


def pef_log_power(x, window, pos, w, band_width, *, fft_length: int,
                  slide_length: int, bins) -> torch.Tensor:
    """PEF's log-grid power of every frame of fp32 recordings ``x`` (...,
    samples), frame t at ``x[..., t * slide_length:][:fft_length]`` (the
    frames that fit) times ``window``: (..., T, G), G = ``pos``'s length,
    ``(p[pos] + w (p[pos + 1] - p[pos])) band_width`` of the frame's power
    spectrum p at 2 fft_length.  ``bins``: (lo, hi), the least and the
    greatest linear bin the grid reads (``pos.min()``, ``pos.max() + 1``),
    which the kernel keeps; ``pos`` is int32 on the card.

    A CUDA tensor launches the kernel (sm_90 only, fft_length 4096) or
    raises; a CPU tensor takes the plain version."""
    with scope("af.kernel.pef_log_power"):
        _check_f32(x=x, window=window, w=w, band_width=band_width)
        if window.shape[-1] != fft_length or not (
                pos.shape == w.shape == band_width.shape):
            raise ValueError("window needs fft_length points, and pos, w "
                             "and band_width one shape")
        lo, hi = (int(b) for b in bins)
        if not 0 <= lo < hi <= fft_length or slide_length < 1:
            raise ValueError(f"need 0 <= bins[0] < bins[1] <= fft_length "
                             f"and slide_length >= 1, got {bins}, "
                             f"{slide_length}")
        frames = cal_time_length(x.shape[-1], fft_length, slide_length)
        if frames <= 0:
            raise ValueError(f"signal too short to frame: n={x.shape[-1]} "
                             f"fft_length={fft_length}")
        if x.device.type == "cpu":
            return pef_log_power_ref(x, window, pos, w, band_width,
                                     fft_length=fft_length,
                                     slide_length=slide_length)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        if fft_length != FFT_LENGTH:
            raise ValueError(f"pef_log_power needs fft_length {FFT_LENGTH} "
                             f"on the card, got {fft_length}")
        if pos.dtype != torch.int32:
            raise TypeError(f"pos must be int32 on the card, got {pos.dtype}")
        grid = pos.shape[-1]
        out = x.new_empty(x.shape[:-1] + (frames, grid))
        if out.numel() == 0:
            return out
        samples = x.shape[-1]
        x2 = x.reshape(-1, samples).contiguous()
        n = 2 * fft_length
        args = [t.contiguous() for t in (window, pos, w, band_width)]
        _build.launch(_lib().af_pef_log_power, "pef_log_power", x.device,
                      x2.data_ptr(), *(t.data_ptr() for t in args),
                      out.data_ptr(),
                      cuda_fft._kernel_table(n, x.device).data_ptr(),
                      x2.shape[0], samples, frames, slide_length, grid, lo,
                      hi, n.bit_length() - 1)
        pef_log_power.launches += 1
        return out


def pef_xcorr_pitch_ref(lp, ff, log_fre, *, xcorr_length: int, pad_num: int,
                        min_index: int, max_index: int) -> torch.Tensor:
    """Plain version of :func:`pef_xcorr_pitch`: the rows' spectrum at
    ``xcorr_length`` (placed at ``pad_num``), times ``ff``, the half
    spectrum's inverse, and the first arg-max over the lags."""
    X = xcorr_length
    br, bi = afft.fft_parts(lp, n=X, lo=pad_num, bins=X // 2 + 1)
    fr, fi = ff[..., 0], ff[..., 1]
    pr, pi = (br * fr - bi * fi).contiguous(), (br * fi + bi * fr).contiguous()
    del br, bi
    xc = afft.ifft_parts(pr, pi, n=X)
    del pr, pi
    lag = torch.argmax(xc[..., min_index:max_index + 1], dim=-1) + min_index
    return log_fre[lag]


def pef_xcorr_pitch(lp, ff, log_fre, *, xcorr_length: int, pad_num: int,
                    min_index: int, max_index: int) -> torch.Tensor:
    """PEF's pitch from log-grid rows ``lp`` (..., T, G): each row placed at
    ``pad_num`` in ``xcorr_length`` zeros, cross-correlated with the comb
    filter whose spectrum's conjugate ``ff`` holds as (re, im), bins 0 ..
    xcorr_length / 2 ((xcorr_length / 2 + 1, 2)), and ``log_fre`` at the
    first lag of the largest value in [min_index, max_index]: (..., T).

    A CUDA tensor launches the kernel (sm_90 only, xcorr_length 32768,
    G <= 8192 and a multiple of 4, pad_num + G <= 12288: every PEF plan of
    fft_length 4096) or raises; a CPU tensor takes the plain version."""
    with scope("af.kernel.pef_xcorr_pitch"):
        _check_f32(lp=lp, ff=ff, log_fre=log_fre)
        X, G = xcorr_length, lp.shape[-1]
        if ff.shape != (X // 2 + 1, 2):
            raise ValueError(f"ff must be ({X // 2 + 1}, 2), got "
                             f"{tuple(ff.shape)}")
        if not (0 <= pad_num and pad_num + G <= X
                and 0 <= min_index <= max_index < min(X, log_fre.shape[-1])):
            raise ValueError(f"need the row inside {X} points and 0 <= "
                             f"min_index <= max_index < len(log_fre), got "
                             f"pad_num {pad_num}, G {G}, lags {min_index}.."
                             f"{max_index}")
        if lp.device.type == "cpu":
            return pef_xcorr_pitch_ref(lp, ff, log_fre, xcorr_length=X,
                                       pad_num=pad_num, min_index=min_index,
                                       max_index=max_index)
        if lp.device.type != "cuda":
            raise ValueError(f"unsupported device {lp.device}")
        if X != XCORR_LENGTH or G > GRID_MAX or G % 4 or (
                pad_num + G > LIVE_END):
            raise ValueError(f"pef_xcorr_pitch needs xcorr_length "
                             f"{XCORR_LENGTH} and rows of at most "
                             f"{GRID_MAX}, a multiple of 4, ending by "
                             f"{LIVE_END}, on the card, got {X}, {G} at "
                             f"{pad_num}")
        out = lp.new_empty(lp.shape[:-1])
        if out.numel() == 0:
            return out
        rows = lp.reshape(-1, G).contiguous()
        if rows.data_ptr() % 16:      # the kernel stages rows by TMA
            rows = rows.clone()
        ffc, lf = ff.contiguous(), log_fre.contiguous()
        _build.launch(_lib().af_pef_xcorr_pitch, "pef_xcorr_pitch",
                      lp.device, rows.data_ptr(), ffc.data_ptr(),
                      lf.data_ptr(), out.data_ptr(),
                      cuda_fft._kernel_table(X, lp.device).data_ptr(),
                      rows.shape[0], G, pad_num, min_index, max_index,
                      X.bit_length() - 1)
        pef_xcorr_pitch.launches += 1
        return out


pef_log_power.launches = 0
pef_xcorr_pitch.launches = 0
