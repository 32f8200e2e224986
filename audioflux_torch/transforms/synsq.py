"""Synchrosqueezing of CWT-family output.

Counterpart of ``audioflux_tpu/transforms/synsq.py`` (reference
``src/synsq_algorithm.c``): per-cell instantaneous frequency from the
unwrapped phase derivative, mapped to an output bin by the band layout
(log / linear / nearest neighbour), then a scatter-add of the complex
values above threshold.  The map from the cells to the bins, threshold
included, is one kernel (``ops.cuda_unwrap.synsq_bins``; on the CPU its
plain version) and the scatter another (``ops.cuda_scatter.
columnar_scatter``, up to 512 bins); ``force_xla_unwrap`` keeps the
PyTorch chain of :func:`_synsq_map` instead.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import (as_tensor, f32_scalar,
                                         resolve_device)
from audioflux_torch.ops.cuda_scatter import MAX_OUT_SIZE
from audioflux_torch.ops.cuda_unwrap import bin_map, c_unwrap, synsq_bins
from audioflux_torch.ops.scatter import (batched_scatter_add,
                                         columnar_scatter_add)
from audioflux_torch.types import SpectralFilterBankScaleType

__all__ = ["Synsq", "scale_kind"]


def scale_kind(scale_type) -> str:
    """Bin-mapping family for a filter-bank scale (synsq_algorithm.c's
    three index formulas).  Shared by Synsq and WSST so the mapping cannot
    drift between them."""
    S = SpectralFilterBankScaleType
    st = S(scale_type)
    if st > S.LOG:
        raise ValueError(f"unsupported scale {st.name}")
    if st in (S.OCTAVE, S.LOG):
        return "log"
    if st in (S.LINEAR, S.LINSPACE):
        return "linear"
    return "nearest"


def _synsq_map(D: torch.Tensor, fre_arr: torch.Tensor, *, scale_kind, num,
               samplate) -> torch.Tensor:
    """Per-cell target-bin map (int32, same shape as D) as a chain of
    PyTorch operations: phase, the prefix-sum form of the unwrap along
    time within each band row, phase rate, bin."""
    # phase = atan2(REAL, IMAG): the reference's argument order
    # (synsq_algorithm.c:155), then the C unwrap and the diff over 2 pi
    phase = torch.atan2(D.real, D.imag)
    ph = c_unwrap(phase)
    # backward diff stored at j, first column 0 (__mdiff2 axis=1); the C
    # then overwrites the LAST column with the second-to-last
    # (synsq_algorithm.c:191-193), so the final two phase-rate columns are
    # identical
    d = ph[..., 1:] - ph[..., :-1]
    d = torch.cat([torch.zeros_like(d[..., :1]), d[..., :-1], d[..., -2:-1]],
                  dim=-1) / f32_scalar(2 * np.pi, D.device)
    return bin_map(d, fre_arr, scale_kind=scale_kind, num=num,
                   samplate=samplate)


def _compose_order(fi: torch.Tensor, num: int, order: int) -> torch.Tensor:
    """Order composition over the transposed flat view
    (synsq_algorithm.c:222-238 indexes [t*num+j]): the (num, T) map is
    reread as (T, num) without a transpose, literally as the C does.  Each
    cell looks up the target bin of another band."""
    T = fi.shape[-1]
    for _ in range(max(order, 1) - 1):
        flat = fi.reshape(fi.shape[:-2] + (T, num))
        valid = (flat >= 0) & (flat < num)
        g = torch.gather(flat, -1, torch.clamp(flat, 0, num - 1).long())
        flat = torch.where(valid, g, torch.zeros_like(g))
        fi = flat.reshape(fi.shape)
    return fi


def _reassign_scatter(D: torch.Tensor, fi: torch.Tensor, *, num: int,
                      thresh: float) -> torch.Tensor:
    """Threshold + complex scatter-add into ``num`` output bins, shared by
    synsq and wsst (synsq_algorithm.c:240-258 / wsst_algorithm.c)."""
    T = D.shape[-1]
    power = D.real ** 2 + D.imag ** 2
    th = f32_scalar(thresh, D.device)
    ok = (fi >= 0) & (fi < num) & (power > th * th)
    if num <= MAX_OUT_SIZE:
        # columnar reassignment: dropped cells go to bin ``num``
        return columnar_scatter_add(D, torch.where(ok, fi,
                                                   torch.full_like(fi, num)),
                                    num)
    j = torch.arange(T, device=D.device).expand(fi.shape)
    flat_idx = torch.where(ok, fi.long() * T + j,
                           torch.full_like(j, num * T))
    out = batched_scatter_add(D.reshape(D.shape[:-2] + (-1,)),
                              flat_idx.reshape(flat_idx.shape[:-2] + (-1,)),
                              num * T)
    return out.reshape(D.shape[:-2] + (num, T))


def _synsq_impl(D, fre_arr, *, scale_kind, num, samplate, thresh, order,
                force_xla_unwrap: bool = False):
    if force_xla_unwrap:
        fi = _synsq_map(D, fre_arr, scale_kind=scale_kind, num=num,
                        samplate=samplate)
    elif order == 1 and num <= MAX_OUT_SIZE:
        # one pass from the cells to the drop-coded bin (dropped: num)
        fi = synsq_bins(D.contiguous(), fre_arr, scale_kind, num, samplate,
                        thresh)
        return columnar_scatter_add(D, fi, num)
    else:
        fi = synsq_bins(D.contiguous(), fre_arr, scale_kind, num, samplate)
    fi = _compose_order(fi, num, order)
    return _reassign_scatter(D, fi, num=num, thresh=thresh)


class Synsq:
    """API mirrors ``python/audioflux/synsq.py``, plus ``device`` (``None``
    means ``cuda``)."""

    def __init__(self, num: int, radix2_exp: int, samplate: int = 32000,
                 order: int = 1, thresh: float = 0.001, device=None):
        self.device = resolve_device(device)
        self.num = int(num)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.samplate = samplate
        self.order = max(int(order), 1)
        self.thresh = float(thresh)

    def synsq(self, m_data_arr, filter_bank_type, fre_arr,
              force_xla_unwrap: bool = False):
        """m_data_arr: complex (..., num, time) CWT-family output (a
        tensor on the plan's device, or host data); fre_arr: (num,)
        ascending band frequencies.  ``force_xla_unwrap`` pins the PyTorch
        chain with the prefix-sum form of the unwrap also on the card (the
        accuracy gates compare the kernel path with it)."""
        kind = scale_kind(filter_bank_type)
        if isinstance(m_data_arr, torch.Tensor):
            if m_data_arr.device.type != self.device.type:
                raise ValueError(f"tensor on {m_data_arr.device}, plan on "
                                 f"{self.device}")
            D = m_data_arr.to(torch.complex64)
        else:
            D = torch.from_numpy(
                np.array(m_data_arr, dtype=np.complex64)).to(self.device)
        return _synsq_impl(D, as_tensor(fre_arr, self.device),
                           scale_kind=kind, num=self.num,
                           samplate=float(self.samplate),
                           thresh=self.thresh, order=self.order,
                           force_xla_unwrap=force_xla_unwrap)
