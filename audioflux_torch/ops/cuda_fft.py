"""Batched FFTs for power-of-two n in [2048, 32768]: the CUDA kernels of
``csrc/fft_pow2.cu`` (forward, inverse, fused autocorrelation, and YIN's
autocorrelation straight from the clips) and their plain PyTorch versions.

Counterpart of ``audioflux_tpu/ops/pallas_fft.py`` (``fft4_fwd``,
``fft4_inv``, ``fft4_autocorr``, ``supports``).  The kernels read and
write natural bin order, so the TPU package's layout converters
(``t_to_natural``, ``natural_to_t``, ``permute_bins_t``) have no
counterpart here: consumers slice the first n//2+1 bins of the natural
spectrum and never add the mirror half.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.ops import _build
from audioflux_torch.ops.backend import require_sm90
from audioflux_torch.ops.frame import cal_time_length, frame_signal

__all__ = ["supports", "fft_fwd", "fft_fwd_ref", "fft_inv", "fft_inv_ref",
           "fft_autocorr", "fft_autocorr_ref", "fft_autocorr_yin",
           "fft_autocorr_yin_ref", "twiddle_table"]

REGISTER_N = (2048, 4096)   # the lengths of the register-resident route
FOUR_STEP_MIN = 32768       # from here on the four-step split with its buffer


def supports(n: int) -> bool:
    """The kernel's domain: pow2 n in [2048, 32768]."""
    return n > 0 and not n & (n - 1) and 2048 <= n <= 32768


@functools.lru_cache(maxsize=None)
def twiddle_table(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) fp32 table exp(-2 pi i k / n), k < n, on ``device``; built in
    float64 on the host, so the kernels use no fast-math sine or cosine."""
    ang = -2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fft_pow2")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rows = [p, p, p, p, p, p, ll, i, i, p]
    auto = [p, p, p, p, p, ll, i, p]
    yin = [p, p, p, ll, ll, i, i, i, i, p]
    for fn, argtypes in ((lib.af_fft_pow2_fwd, rows),
                         (lib.af_fft_pow2_inv, rows),
                         (lib.af_fft_pow2_autocorr, auto),
                         (lib.af_fft_pow2_autocorr_yin, yin)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_rows(who: str, **tensors) -> int:
    """The checks every wrapper makes: pow2 n in the kernels' domain,
    float32, contiguous, one shape and one device.  Returns n."""
    first = next(t for t in tensors.values() if t is not None)
    n = first.shape[-1]
    if not supports(n):
        raise ValueError(f"{who} needs pow2 n in [2048, 32768], got {n}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{' and '.join(tensors)} must share shape and "
                             "device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    return n


def _call(fn, who: str, x: torch.Tensor, n: int, *ptrs, stages=None):
    """Launch ``fn(*ptrs, scratch, tw, batch, log2n[, stages], stream)`` on
    ``x``'s device and stream; raise on a CUDA error.  ``scratch`` is the
    four-step split's device buffer (n >= FOUR_STEP_MIN only)."""
    require_sm90(x.device)
    batch, log2n = x.numel() // n, n.bit_length() - 1
    scratch = (torch.empty((batch, n, 2), dtype=torch.float32,
                           device=x.device) if n >= FOUR_STEP_MIN else None)
    tw = twiddle_table(n, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, None if scratch is None else scratch.data_ptr(),
                 tw.data_ptr(), batch, log2n,
                 *(() if stages is None else (stages,)), stream)
    if err:
        raise RuntimeError(f"{who} launch failed: CUDA error {err}")


def fft_fwd_ref(xr: torch.Tensor, xi: torch.Tensor | None = None):
    """Plain version: ``torch.fft.fft`` of ``xr + i xi`` -> (re, im)."""
    z = xr if xi is None else torch.complex(xr, xi)
    y = torch.fft.fft(z, dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def fft_fwd(xr: torch.Tensor, xi: torch.Tensor | None = None):
    """Forward FFT of (..., n) fp32 rows (``xi=None``: real input) ->
    (re, im), each (..., n), natural bin order, the full spectrum.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version.  ~1e-6 of the peak (the TPU kernel's contract
    is 5e-5).  At n = 2048 and 4096 real rows are transformed two at a time
    (one packed complex transform, separated in the kernel)."""
    n = _check_rows("fft_fwd", xr=xr, xi=xi)
    if xr.device.type == "cpu":
        return fft_fwd_ref(xr, xi)
    return _fwd(xr, xi, n)


def _fwd(xr, xi, n, stages=3):
    """Launch the forward kernel; ``stages`` 1 and 2 (n = 2048 and 4096)
    cut it after its first or second pass, for measurements (the output
    is then not the spectrum)."""
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    if xr.numel() == 0:
        return yr, yi
    _call(_lib().af_fft_pow2_fwd, "fft_pow2 forward", xr, n, xr.data_ptr(),
          None if xi is None else xi.data_ptr(), yr.data_ptr(),
          yi.data_ptr(), stages=stages)
    fft_fwd.launches += 1
    fft_fwd.register_launches += int(n in REGISTER_N)
    fft_fwd.four_step_launches += int(n >= FOUR_STEP_MIN)
    return yr, yi


def fft_inv_ref(yr: torch.Tensor, yi: torch.Tensor, out_imag: bool = True):
    """Plain version: ``torch.fft.ifft`` of ``yr + i yi`` -> (re, im or
    None)."""
    x = torch.fft.ifft(torch.complex(yr, yi), dim=-1)
    return x.real.contiguous(), (x.imag.contiguous() if out_imag else None)


def fft_inv(yr: torch.Tensor, yi: torch.Tensor, out_imag: bool = True):
    """Inverse FFT of a natural-order (..., n) fp32 spectrum pair -> (re,
    im), each (..., n), 1/n included: the exact inverse of :func:`fft_fwd`.
    ``out_imag=False`` returns ``(re, None)`` and writes no imaginary
    output (use when the result is known to be real).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    n = _check_rows("fft_inv", yr=yr, yi=yi)
    if yr.device.type == "cpu":
        return fft_inv_ref(yr, yi, out_imag)
    xr = torch.empty_like(yr)
    xi = torch.empty_like(yr) if out_imag else None
    if yr.numel() == 0:
        return xr, xi
    _call(_lib().af_fft_pow2_inv, "fft_pow2 inverse", yr, n, yr.data_ptr(),
          yi.data_ptr(), xr.data_ptr(), None if xi is None else xi.data_ptr(),
          stages=3)
    fft_inv.launches += 1
    fft_inv.register_launches += int(n in REGISTER_N)
    fft_inv.four_step_launches += int(n >= FOUR_STEP_MIN)
    return xr, xi


def fft_autocorr_ref(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Plain version: ``0.5 * Im(ifft(fft(xr + i xi)^2))``."""
    z = torch.fft.fft(torch.complex(xr, xi), dim=-1)
    return (0.5 * torch.fft.ifft(z * z, dim=-1).imag).contiguous()


def fft_autocorr(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``0.5 * Im(ifft(fft(xr + i xi)^2))`` of two (..., n) fp32 rows: the
    circular convolution of ``xr`` with ``xi``, in one pass over the two
    operands (the square never leaves the card's on-chip memory at
    n <= 16384; at n = 2048 and 4096 the whole round trip runs in
    registers).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    n = _check_rows("fft_autocorr", xr=xr, xi=xi)
    if xr.device.type == "cpu":
        return fft_autocorr_ref(xr, xi)
    out = torch.empty_like(xr)
    if xr.numel() == 0:
        return out
    _call(_lib().af_fft_pow2_autocorr, "fft_pow2 autocorrelation", xr, n,
          xr.data_ptr(), xi.data_ptr(), out.data_ptr())
    fft_autocorr.launches += 1
    return out


def fft_autocorr_yin_ref(x: torch.Tensor, fft_length: int,
                         slide_length: int, auto_length: int) -> torch.Tensor:
    """Plain version of :func:`fft_autocorr_yin`: the frames, their
    reversed prefix padded to ``fft_length``, :func:`fft_autocorr_ref`, and
    the lags from ``auto_length`` on."""
    frames = frame_signal(x, fft_length, slide_length)
    rev = F.pad(frames[..., :auto_length + 1].flip(-1),
                (0, fft_length - auto_length - 1))
    acf = fft_autocorr_ref(frames.contiguous(), rev.contiguous())
    return acf[..., auto_length:].contiguous()


def fft_autocorr_yin(x: torch.Tensor, fft_length: int, slide_length: int,
                     auto_length: int) -> torch.Tensor:
    """YIN's autocorrelation of every frame of fp32 clips ``x`` (...,
    samples): frame t is ``x[..., t * slide_length:][:fft_length]`` (the
    frames that fit, no padding), ``z = frame + i rev`` with ``rev[j] =
    frame[auto_length - j]`` for ``j <= auto_length`` (else 0), and the
    result ``0.5 * Im(ifft(fft(z)^2))`` at lags ``auto_length ..
    fft_length - 1``: (..., T, fft_length - auto_length).  The kernel
    reads each frame straight from the clip and writes only the lags kept;
    ``fft_length`` is 2048 or 4096 (:data:`REGISTER_N`).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    if fft_length not in REGISTER_N:
        raise ValueError(f"fft_autocorr_yin needs fft_length in "
                         f"{REGISTER_N}, got {fft_length}")
    if not 0 <= auto_length < fft_length or slide_length < 1:
        raise ValueError(f"need 0 <= auto_length < fft_length and "
                         f"slide_length >= 1, got {auto_length}, "
                         f"{slide_length}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    samples = x.shape[-1]
    frames = cal_time_length(samples, fft_length, slide_length)
    if frames <= 0:
        raise ValueError(f"signal too short to frame: n={samples} "
                         f"fft_length={fft_length}")
    if x.device.type == "cpu":
        return fft_autocorr_yin_ref(x, fft_length, slide_length, auto_length)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    require_sm90(x.device)
    lead = x.shape[:-1]
    out = torch.empty(lead + (frames, fft_length - auto_length),
                      dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    x2 = x.reshape(-1, samples).contiguous()
    tw = twiddle_table(fft_length, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().af_fft_pow2_autocorr_yin(
            x2.data_ptr(), out.data_ptr(), tw.data_ptr(), x2.shape[0],
            samples, frames, slide_length, auto_length,
            fft_length.bit_length() - 1, stream)
    if err:
        raise RuntimeError(f"fft_pow2 YIN autocorrelation launch failed: "
                           f"CUDA error {err}")
    fft_autocorr_yin.launches += 1
    return out


fft_fwd.launches = 0
fft_inv.launches = 0
fft_fwd.register_launches = 0   # those at n = 2048, 4096 (the register route)
fft_inv.register_launches = 0
fft_fwd.four_step_launches = 0  # those at n = 32768 (the four-step route)
fft_inv.four_step_launches = 0
fft_autocorr.launches = 0
fft_autocorr_yin.launches = 0
