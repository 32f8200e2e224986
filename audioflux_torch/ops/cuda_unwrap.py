"""Phase unwrap along time and backward difference: the CUDA kernel
``csrc/unwrap_diff.cu`` and its plain PyTorch version.

Counterpart of ``audioflux_tpu/ops/pallas_unwrap.py`` (``unwrap_diff``).
The kernel takes every (rows, T) with T >= 1 (the TPU kernel's gate on
row and lane multiples served its block shapes) and equals the plain
version bit for bit: both make the same fp32 operations, each rounded on
its own, around an exact integer prefix sum.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audioflux_torch.ops import _build
from audioflux_torch.ops.backend import f32_scalar, require_sm90

__all__ = ["c_unwrap", "unwrap_diff", "unwrap_diff_ref"]


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
    fn = _build.load("unwrap_diff").af_unwrap_diff
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, p]
    fn.restype = ctypes.c_int
    return fn


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
        err = _lib()(phase.data_ptr(), out.data_ptr(), rows, T, stream)
    if err:
        raise RuntimeError(f"unwrap_diff launch failed: CUDA error {err}")
    unwrap_diff.launches += 1
    return out


unwrap_diff.launches = 0
