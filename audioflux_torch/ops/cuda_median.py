"""Exact sliding median along one axis: the CUDA kernel
``csrc/median_filter.cu`` and its plain PyTorch version.

Counterpart of ``audioflux_tpu/ops/pallas_median.py``
(``median_filter_last_axis``).  Odd ``order``, order//2 zeros of padding
per side; the output is the order//2-th order statistic of each window,
equal value for value to a full sort.  Orders 21 and 31 (the HPSS
defaults) give a thread a run of ``RUN`` neighbouring outputs and select
their medians with one shared network held in registers
(``ops/median_network.py`` builds it); every other odd order counts ranks
over the window in shared memory.

Unlike the TPU kernel it takes the filtered axis as ``dim``: HPSS's
time-axis median runs in place on the (..., T, bins) magnitude instead of
between two transposes, each of which would move as many bytes as the
kernel itself.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from audioflux_torch.observe import scope, setup_table
from audioflux_torch.ops import _build
from audioflux_torch.ops.filter import median_filter
from audioflux_torch.ops.median_network import INSTANCES, RUN

__all__ = ["median_filter_last_axis", "median_filter_last_axis_ref", "RUN"]

_SMEM_MAX = 227 * 1024         # the most a block may have on sm_90
_BLOCK_OUTPUTS = 1024          # rank counting: outputs per block (4 a thread)


@functools.lru_cache(maxsize=None)
@setup_table
def _lib():
    lib = _build.load("median_filter")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.af_median_filter.argtypes = [p, p, ll, ll, ll, i, i, i, i, p]
    lib.af_median_filter.restype = ctypes.c_int
    lib.af_minmax_probe.argtypes = [p, ll, i, p]
    lib.af_minmax_probe.restype = ctypes.c_int
    return lib


def has_network(order: int) -> bool:
    """Whether the kernel holds a network for ``order`` (else it counts
    ranks)."""
    return (order, RUN) in INSTANCES


def _tile(order: int, inner: int):
    """(tl, ti) of rank counting: a block's outputs along the filtered axis
    and along the inner axis.  ti covers up to 32 neighbouring inner cells
    (one warp's width of coalesced addresses), shrunk until the staged
    span (tl + order - 1) * ti fits shared memory."""
    ti = 1
    while ti < min(inner, 32):
        ti *= 2
    while True:
        tl = _BLOCK_OUTPUTS // ti
        if 4 * (tl + order - 1) * ti <= _SMEM_MAX:
            return tl, ti
        if ti == 1:
            raise ValueError(f"median order {order} does not fit the "
                             "kernel's shared memory")
        ti //= 2


def median_filter_last_axis_ref(x: torch.Tensor, order: int,
                                dim: int = -1) -> torch.Tensor:
    """Plain version: ``ops.filter.median_filter`` (pad, unfold, full
    sort)."""
    return median_filter(x, order, dim)


def median_filter_last_axis(x: torch.Tensor, order: int,
                            dim: int = -1) -> torch.Tensor:
    """Median filter of a contiguous fp32 tensor along ``dim`` (default
    the last axis), odd ``order``, zero padding; ``order`` < 2 or even
    returns the input unchanged.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.median_filter_last_axis"):
        if order < 2 or order % 2 == 0:
            return x
        if x.dtype != torch.float32:
            raise TypeError(f"x must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        if x.dim() == 0:
            raise ValueError("x must have at least one axis")
        if x.device.type == "cpu":
            return median_filter_last_axis_ref(x, order, dim)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return _launch(x, order, dim)


def _launch(x: torch.Tensor, order: int, dim: int,
            stages: int = 2) -> torch.Tensor:
    """Run the kernel on the contiguous CUDA tensor ``x``.  ``stages`` 1
    (a network order only: loads and stores, the output is then not the
    median) is for measurements."""
    dim = dim % x.dim()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    length = x.shape[dim]
    inner = math.prod(x.shape[dim + 1:])
    outer = x.numel() // (length * inner)
    if not has_network(order) and stages != 2:
        raise ValueError(f"order {order} has no network to cut")
    tl, ti = _tile(order, inner)
    _build.launch(_lib().af_median_filter, "median_filter", x.device,
                  x.data_ptr(), out.data_ptr(), outer, length, inner, order,
                  stages, tl, ti)
    median_filter_last_axis.launches += 1
    if has_network(order):
        median_filter_last_axis.network_launches += 1
    return out


def minmax_probe(threads: int, iters: int, device) -> torch.Tensor:
    """Launch the min/max issue-rate probe: ``threads`` (a multiple of
    256) x ``iters`` x 38 min/max over random data; returns the data."""
    data = torch.rand((threads, 8), device=device)
    _build.launch(_lib().af_minmax_probe, "minmax probe", data.device,
                  data.data_ptr(), threads, iters)
    return data


median_filter_last_axis.launches = 0
median_filter_last_axis.network_launches = 0   # those that ran a network
