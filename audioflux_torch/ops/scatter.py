"""Scatter-adds of the reassignment transforms (synsq / wsst).

Counterpart of ``audioflux_tpu/ops/scatter.py``: ``columnar_scatter_add``
and ``batched_scatter_add``.  The TPU package's one-hot and radix-split
matrix forms worked around that backend's serialised scatter and have no
counterpart: the columnar form is the direct scatter kernel of
``ops.cuda_scatter``, the flat form one ``index_add_``.
``reassign_blocked_scatter_add`` is not ported yet (it belongs to
``transforms/reassign.py``).
"""

from __future__ import annotations

import math

import torch

from audioflux_torch.ops.cuda_scatter import columnar_scatter

__all__ = ["batched_scatter_add", "columnar_scatter_add"]


def columnar_scatter_add(values: torch.Tensor, fi: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """Per-column scatter-add: ``out[..., f, t] = sum over i with
    fi[..., i, t] == f of values[..., i, t]``; out-of-range rows drop.
    values: complex (..., R, T); fi: integer (..., R, T); returns
    complex64 (..., out_size, T).  ``out_size <= 512`` on the card."""
    lead = values.shape[:-2]
    R, T = values.shape[-2:]
    out = columnar_scatter(
        values.reshape(-1, R, T).to(torch.complex64).contiguous(),
        fi.reshape(-1, R, T).to(torch.int32).contiguous(), out_size)
    return out.reshape(lead + (out_size, T))


def batched_scatter_add(values: torch.Tensor, flat_idx: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """Scatter-add ``values`` into per-batch buffers of ``out_size`` slots.
    values, flat_idx: (..., n); an index outside ``[0, out_size)`` drops
    its value.  Returns (..., out_size) of ``values``' dtype.

    One ``index_add_`` into a flat (batch, out_size + 1) buffer whose last
    slot per batch takes the dropped values.  On the card the order of the
    additions into one slot is not fixed."""
    lead = values.shape[:-1]
    n = values.shape[-1]
    nb = math.prod(lead)
    idx = flat_idx.reshape(nb, n).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < out_size), idx,
                      torch.full_like(idx, out_size))
    idx = idx + torch.arange(nb, device=idx.device)[:, None] * (out_size + 1)
    cpx = values.is_complex()
    v = values.reshape(nb * n)
    v = torch.view_as_real(v.to(torch.complex64)) if cpx else v[:, None]
    buf = torch.zeros((nb * (out_size + 1), v.shape[1]), dtype=v.dtype,
                      device=values.device)
    buf.index_add_(0, idx.reshape(-1), v)
    buf = buf.reshape(nb, out_size + 1, -1)[:, :out_size]
    out = torch.view_as_complex(buf.contiguous()) if cpx else buf[..., 0]
    return out.reshape(lead + (out_size,))
