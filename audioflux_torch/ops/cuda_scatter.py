"""Per-column complex scatter-add (the synchrosqueezing reassignment): the
CUDA kernel ``csrc/columnar_scatter.cu`` and its plain PyTorch version.

Counterpart of ``audioflux_tpu/ops/pallas_scatter.py``
(``columnar_scatter_pallas``).  Any number of input rows, ``out_size`` up
to 512, any T.  Kernel and plain version add each bin's cells in ascending
input row, so they agree bit for bit; neither uses atomics.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audioflux_torch.observe import scope, setup_table
from audioflux_torch.ops import _build

__all__ = ["MAX_OUT_SIZE", "columnar_scatter", "columnar_scatter_ref"]

MAX_OUT_SIZE = 512     # a column's sums must fit a block's shared memory


@functools.lru_cache(maxsize=None)
@setup_table
def _lib():
    fn = _build.load("columnar_scatter").af_columnar_scatter
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, ll, i, i, ll, p]
    fn.restype = ctypes.c_int
    return fn


def columnar_scatter_ref(values: torch.Tensor, fi: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """Plain version: one ``scatter_add_`` along the bin axis per input
    row, in ascending row order, into a (B, out_size + 1, T) buffer whose
    last row takes the dropped cells.  Within one step every column adds
    to one bin only, so no step has duplicate targets and the order of
    every sum is fixed."""
    B, R, T = values.shape
    buf = torch.zeros((B, out_size + 1, T, 2), dtype=torch.float32,
                      device=values.device)
    planes = torch.view_as_real(values)                      # (B, R, T, 2)
    idx = torch.where((fi >= 0) & (fi < out_size), fi,
                      torch.full_like(fi, out_size)).to(torch.int64)
    idx = idx[..., None].expand(B, R, T, 2)
    for i in range(R):
        buf.scatter_add_(1, idx[:, i:i + 1], planes[:, i:i + 1])
    return torch.view_as_complex(buf[:, :out_size].contiguous())


def columnar_scatter(values: torch.Tensor, fi: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """``out[b, f, t] = sum_i [fi[b, i, t] == f] * values[b, i, t]``, the
    rows added in ascending ``i``; an ``fi`` outside ``[0, out_size)``
    drops its cell.  values: (B, R, T) complex64; fi: (B, R, T) int32;
    returns (B, out_size, T) complex64.

    A CUDA tensor launches the kernel (sm_90 only, ``out_size <= 512``) or
    raises; a CPU tensor takes the plain version."""
    with scope("af.kernel.columnar_scatter"):
        if values.dim() != 3 or fi.shape != values.shape:
            raise ValueError(f"values and fi must share a (B, R, T) shape, "
                             f"got {tuple(values.shape)} and "
                             f"{tuple(fi.shape)}")
        if values.dtype != torch.complex64 or fi.dtype != torch.int32:
            raise TypeError(f"values must be complex64 and fi int32, got "
                            f"{values.dtype} and {fi.dtype}")
        if fi.device != values.device:
            raise ValueError("values and fi must lie on one device")
        if out_size < 1:
            raise ValueError("out_size must be positive")
        if values.device.type == "cpu":
            return columnar_scatter_ref(values, fi, out_size)
        if values.device.type != "cuda":
            raise ValueError(f"unsupported device {values.device}")
        if out_size > MAX_OUT_SIZE:
            raise ValueError(f"the kernel takes out_size <= {MAX_OUT_SIZE}, "
                             f"got {out_size}")
        if not values.is_contiguous() or not fi.is_contiguous():
            raise ValueError("values and fi must be contiguous")
        B, R, T = values.shape
        out = torch.empty((B, out_size, T), dtype=torch.complex64,
                          device=values.device)
        if out.numel() == 0:
            return out
        _build.launch(_lib(), "columnar_scatter", values.device,
                      values.data_ptr(), fi.data_ptr(), out.data_ptr(), B, R,
                      out_size, T)
        columnar_scatter.launches += 1
        return out


columnar_scatter.launches = 0
