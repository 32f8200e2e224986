"""Sliding median / max filters matching the reference C semantics.

- median (flux_vector.c:__vmedianfilter): odd ``order``, zero padding of
  order//2 each side, median of each window.
- max (flux_vector.c:__vmaxfilter): window [i-order//2, i-1+(order-order//2)]
  clamped to the array — shorter windows at the edges, no padding.

Counterpart of ``audioflux_tpu/ops/filter.py``, in plain PyTorch.
``median_filter`` is also the plain version of the CUDA median kernel
(``ops.cuda_median``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["median_filter", "max_filter"]


def _windows(x: torch.Tensor, order: int, left: int, right: int, value):
    """(..., n) -> (..., n, order) sliding windows over the padded axis."""
    return F.pad(x, (left, right), value=value).unfold(-1, order, 1)


def median_filter(x: torch.Tensor, order: int, dim: int = -1) -> torch.Tensor:
    """Median filter along ``dim`` with zero padding (order odd >= 3): the
    order//2-th order statistic of a full sort of each window."""
    if order < 2 or order % 2 == 0:
        return x
    x = x.movedim(dim, -1)
    half = order // 2
    win = _windows(x, order, half, half, 0.0)
    med = torch.sort(win, dim=-1).values[..., half]
    return med.movedim(-1, dim).contiguous()


def max_filter(x: torch.Tensor, order: int, dim: int = -1) -> torch.Tensor:
    """Max filter along ``dim`` with edge-clamped windows."""
    if order < 1:
        return x
    x = x.movedim(dim, -1)
    left = order // 2
    win = _windows(x, order, left, order - left,
                   torch.finfo(x.dtype).min)
    return win.amax(dim=-1)[..., :x.shape[-1]].movedim(-1, dim).contiguous()
