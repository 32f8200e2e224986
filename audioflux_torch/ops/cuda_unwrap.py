"""Phase unwrap along time and backward difference: the CUDA kernel
``csrc/unwrap_diff.cu`` and its plain PyTorch version, with a second entry
that runs Synsq's whole bin map around it.

Counterpart of ``audioflux_tpu/ops/pallas_unwrap.py`` (``unwrap_diff``).
The kernel takes every (rows, T) with T >= 1 (the TPU kernel's gate on
row and lane multiples served its block shapes) and equals the plain
version bit for bit: both make the same fp32 operations, each rounded on
its own, around an exact integer prefix sum.  :func:`synsq_bins` reads
the complex CWT cells once and writes Synsq's bin of each (the phase, the
unwrap and the difference, the phase rate, the band layout's bin and the
threshold's drop code), the work of ``transforms/synsq.py``'s PyTorch
chain in one pass.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audioflux_torch.observe import scope
from audioflux_torch.ops import _build
from audioflux_torch.ops.backend import f32_scalar, require_sm90

__all__ = ["c_unwrap", "unwrap_diff", "unwrap_diff_ref", "bin_map",
           "synsq_bins", "synsq_bins_ref", "SCALE_KINDS"]

SCALE_KINDS = ("log", "linear", "nearest")   # the kernel's kind codes 0, 1, 2
_MAX_FRE = 8192    # csrc/unwrap_diff.cu kMaxFre: band frequencies staged


def c_unwrap(x: torch.Tensor) -> torch.Tensor:
    """The reference C's ``__vunwrap`` along the last axis
    (``flux_vector.c``; ``audioflux_tpu/transforms/synsq.py:_c_unwrap``).

    The C compares each sample with the unwrapped previous one, but every
    step rebuilds y from the fresh wrapped sample plus a multiple of 2 pi,
    so the recurrence is a prefix sum of per-step wrap counts:
    ``y[j] = x[j] + 2 pi * cumsum(k)[j]`` with k from the principal
    difference of the wrapped samples, in the C's fp32 expressions."""
    two_pi = f32_scalar(2 * np.pi, x.device)
    pi = f32_scalar(np.pi, x.device)
    cur, prev = x[..., 1:], x[..., :-1]
    sub = (cur - prev).abs()
    t = torch.floor(sub / two_pi)
    mod = sub - t * two_pi
    t = t + (mod > pi).to(x.dtype)
    k = torch.where(sub < pi, torch.zeros_like(t),
                    torch.where(cur > prev, -t, t))
    c = torch.cumsum(k, dim=-1)
    c = torch.cat([torch.zeros_like(x[..., :1]), c], dim=-1)
    return x + c * two_pi


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("unwrap_diff")
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.af_unwrap_diff.argtypes = [p, p, ll, ll, p]
    lib.af_synsq_bins.argtypes = [p, p, p, i, ll, ll, i, i, f, f, i, p]
    for fn in (lib.af_unwrap_diff, lib.af_synsq_bins):
        fn.restype = ctypes.c_int
    return lib


def unwrap_diff_ref(phase: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`c_unwrap`, then ``e[..., j] = y[..., j] -
    y[..., j-1]`` with ``e[..., 0] = 0``."""
    y = c_unwrap(phase)
    return torch.cat([torch.zeros_like(y[..., :1]),
                      y[..., 1:] - y[..., :-1]], dim=-1)


def unwrap_diff(phase: torch.Tensor) -> torch.Tensor:
    """(rows, T) float32 wrapped phase -> (rows, T) float32 ``e`` with
    ``e[:, 0] = 0`` and ``e[:, j] = unwrap(phase)[:, j] -
    unwrap(phase)[:, j-1]`` (the C's ``__vunwrap``), one read and one write
    of device memory.  The phases must be finite.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.unwrap_diff"):
        if phase.dim() != 2 or phase.shape[1] < 1:
            raise ValueError(f"phase must be (rows, T >= 1), got "
                             f"{tuple(phase.shape)}")
        if phase.dtype != torch.float32:
            raise TypeError(f"phase must be float32, got {phase.dtype}")
        if phase.device.type == "cpu":
            return unwrap_diff_ref(phase)
        if phase.device.type != "cuda":
            raise ValueError(f"unsupported device {phase.device}")
        if not phase.is_contiguous():
            raise ValueError("phase must be contiguous")
        require_sm90(phase.device)
        out = torch.empty_like(phase)
        if phase.numel() == 0:
            return out
        rows, T = phase.shape
        with torch.cuda.device(phase.device):
            stream = torch.cuda.current_stream(phase.device).cuda_stream
            err = _lib().af_unwrap_diff(phase.data_ptr(), out.data_ptr(), rows,
                                        T, stream)
        if err:
            raise RuntimeError(f"unwrap_diff launch failed: CUDA error {err}")
        unwrap_diff.launches += 1
        return out


def bin_map(v_signed: torch.Tensor, fre_arr: torch.Tensor, *, scale_kind,
            num, samplate) -> torch.Tensor:
    """Per-cell target bin (int32) of a signed normalised frequency; cells
    outside ``[0, num)`` get -1 (synsq_algorithm.c's three index formulas;
    Synsq's and WSST's map).

    The range is decided on the float and the value clamped before the
    cast: a float -> int cast of -inf (``log2(0)``), NaN or a value past
    int32 is undefined in PyTorch and differs between the CPU and the card
    (the TPU package's cast saturates, which keeps such cells out of
    range as well)."""
    v = v_signed.abs()
    f = (fre_arr / f32_scalar(samplate, fre_arr.device)).contiguous()
    if scale_kind == "log":
        fmin, fmax = f[0], f[num - 1]
        fi = torch.floor((torch.log2(v) - torch.log2(fmin)) * num
                         / (torch.log2(fmax) - torch.log2(fmin)) + 0.5)
    elif scale_kind == "linear":
        fmin, fmax = f[0], f[num - 1]
        fi = torch.floor((v_signed - fmin).abs() * num / (fmax - fmin) + 0.5)
    else:  # nearest band (mel/bark/erb, __arr_roundIndex)
        idx = torch.clamp(
            torch.searchsorted(f, v.contiguous(), right=True) - 1, 0, num - 2)
        in_range = (v >= f[0]) & (v < f[num - 1])
        left = v - f[idx]
        right = f[idx + 1] - v
        fi = torch.where(left < right, idx, idx + 1)
        return torch.where(in_range, fi, torch.full_like(fi, -1)).to(
            torch.int32)
    valid = (fi >= 0) & (fi < num)
    return torch.where(valid, fi, torch.full_like(fi, -1.0)).to(torch.int32)


def synsq_bins_ref(D: torch.Tensor, fre: torch.Tensor, scale_kind: str,
                   num: int, samplate: float,
                   thresh: float | None = None) -> torch.Tensor:
    """Plain version of :func:`synsq_bins`: the phase ``atan2(re, im)``,
    :func:`unwrap_diff_ref`, the last column set to the one before it,
    / 2 pi, :func:`bin_map`, then with ``thresh`` the drop code of
    ``transforms/synsq.py:_reassign_scatter``."""
    T = D.shape[-1]
    phase = torch.atan2(D.real, D.imag)
    e = unwrap_diff_ref(phase.reshape(-1, T)).reshape(phase.shape)
    # the C overwrites the LAST column with the second-to-last
    # (synsq_algorithm.c:191-193); a one-column row keeps its 0
    if T > 1:
        e = torch.cat([e[..., :-1], e[..., -2:-1]], dim=-1)
    fi = bin_map(e / f32_scalar(2 * np.pi, D.device), fre,
                 scale_kind=scale_kind, num=num, samplate=samplate)
    if thresh is None:
        return fi
    power = D.real ** 2 + D.imag ** 2
    th = f32_scalar(thresh, D.device)
    ok = (fi >= 0) & (fi < num) & (power > th * th)
    return torch.where(ok, fi, torch.full_like(fi, num))


def synsq_bins(D: torch.Tensor, fre: torch.Tensor, scale_kind: str,
               num: int, samplate: float,
               thresh: float | None = None) -> torch.Tensor:
    """Synsq's bin of each cell of complex64 ``D`` (..., T), unwrapped
    along the last axis: int32 of D's shape.  ``fre`` holds the ascending
    band frequencies (float32, at least ``num``); ``scale_kind`` is "log",
    "linear" or "nearest".  Without ``thresh`` a cell out of ``[0, num)``
    gets -1; with it, a cell whose power ``re^2 + im^2`` is not above
    ``thresh^2`` gets ``num`` too (the drop bin of ``columnar_scatter``).
    One read of D and one write of the bins on the card.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.synsq_bins"):
        if D.dtype != torch.complex64 or fre.dtype != torch.float32:
            raise TypeError(f"D must be complex64 and fre float32, got "
                            f"{D.dtype} and {fre.dtype}")
        if D.dim() < 1 or D.shape[-1] < 1:
            raise ValueError(f"D must be (..., T >= 1), got {tuple(D.shape)}")
        if scale_kind not in SCALE_KINDS:
            raise ValueError(f"unknown scale kind {scale_kind!r}")
        if fre.dim() != 1 or not 1 <= num <= fre.shape[0]:
            raise ValueError(f"fre must be 1-D with at least num >= 1 "
                             f"entries, got {tuple(fre.shape)} for "
                             f"num={num}")
        if fre.device != D.device:
            raise ValueError("D and fre must lie on one device")
        if D.device.type == "cpu":
            return synsq_bins_ref(D, fre, scale_kind, num, samplate, thresh)
        if D.device.type != "cuda":
            raise ValueError(f"unsupported device {D.device}")
        if not D.is_contiguous():
            raise ValueError("D must be contiguous")
        if fre.shape[0] > _MAX_FRE:
            raise ValueError(f"the kernel takes at most {_MAX_FRE} bands")
        require_sm90(D.device)
        out = torch.empty(D.shape, dtype=torch.int32, device=D.device)
        if D.numel() == 0:
            return out
        T = D.shape[-1]
        fre = fre.contiguous()
        with torch.cuda.device(D.device):
            stream = torch.cuda.current_stream(D.device).cuda_stream
            err = _lib().af_synsq_bins(
                D.data_ptr(), out.data_ptr(), fre.data_ptr(), fre.shape[0],
                D.numel() // T, T, SCALE_KINDS.index(scale_kind), num,
                float(np.float32(samplate)),
                0.0 if thresh is None else float(np.float32(thresh)),
                int(thresh is not None), stream)
        if err:
            raise RuntimeError(f"synsq_bins launch failed: CUDA error {err}")
        synsq_bins.launches += 1
        return out


unwrap_diff.launches = 0
synsq_bins.launches = 0
