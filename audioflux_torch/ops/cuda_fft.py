"""Batched forward FFT for power-of-two n in [2048, 32768]: the CUDA kernel
``csrc/fft_pow2.cu`` and its plain PyTorch version.

Counterpart of ``audioflux_tpu/ops/pallas_fft.py`` (``fft4_fwd``,
``supports``).  The kernel returns the spectrum in natural bin order, so
the TPU package's layout converters (``t_to_natural``, ``permute_bins_t``)
have no counterpart here: consumers slice the first n//2+1 bins of the
natural spectrum and never add the mirror half.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audioflux_torch.ops import _build
from audioflux_torch.ops.backend import require_sm90

__all__ = ["supports", "fft_fwd", "fft_fwd_ref", "twiddle_table"]


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
    fn = lib.af_fft_pow2_fwd
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


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
    is 5e-5)."""
    n = xr.shape[-1]
    if not supports(n):
        raise ValueError(f"fft_fwd needs pow2 n in [2048, 32768], got {n}")
    for name, t in (("xr", xr), ("xi", xi)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xi is not None and (xi.shape != xr.shape or xi.device != xr.device):
        raise ValueError("xr and xi must share shape and device")
    if xr.device.type == "cpu":
        return fft_fwd_ref(xr, xi)
    if xr.device.type != "cuda":
        raise ValueError(f"unsupported device {xr.device}")
    require_sm90(xr.device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    batch = xr.numel() // n
    if batch == 0:
        return yr, yi
    log2n = n.bit_length() - 1
    scratch = (torch.empty((batch, n, 2), dtype=torch.float32,
                           device=xr.device) if log2n > 14 else None)
    tw = twiddle_table(n, xr.device)
    fn = _lib()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        err = fn(xr.data_ptr(), None if xi is None else xi.data_ptr(),
                 yr.data_ptr(), yi.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 tw.data_ptr(), batch, log2n, stream)
    if err:
        raise RuntimeError(f"fft_pow2 launch failed: CUDA error {err}")
    fft_fwd.launches += 1
    return yr, yi


fft_fwd.launches = 0
