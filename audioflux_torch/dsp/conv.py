"""1-D convolution with full/same/valid modes.

Counterpart of ``audioflux_tpu/dsp/conv.py`` (reference
``src/dsp/conv_algorithm.c``): true convolution (kernel flipped), mode
lengths full=N+M-1, same=N, valid=N-M+1, batched over leading dims.

The convolution is a window view of the padded signal times the reversed
kernel as a matrix product (:func:`window_product`), which runs in full
fp32 on the card (``torch.backends.cuda.matmul.allow_tf32`` stays False):
the counterpart of the TPU package's ``Precision.HIGHEST``
``conv_general_dilated``.  ``conv1d`` would follow cuDNN's TF32 flag,
which is on by default.
"""

from __future__ import annotations

from enum import IntEnum

import torch
import torch.nn.functional as F

from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["ConvModeType", "conv", "window_product"]

_MAX_CELLS = 1 << 25        # window values one product copies (128 MB)


class ConvModeType(IntEnum):
    FULL = 0
    SAME = 1
    VALID = 2


def window_product(x: torch.Tensor, taps: torch.Tensor, count: int,
                   step: int = 1, dilation: int = 1) -> torch.Tensor:
    """``sum_t x[..., q*step + t*dilation] * taps[t]`` for ``q < count``:
    (..., count) for taps (M,), (..., count, K) for taps (M, K).  The
    windows are copied for the product in chunks of at most ``_MAX_CELLS``
    values."""
    m = taps.shape[0]
    span = (m - 1) * dilation + 1
    rows = x.numel() // max(x.shape[-1], 1)
    chunk = max(1, _MAX_CELLS // max(1, rows * m))
    parts = []
    for q0 in range(0, count, chunk):
        c = min(chunk, count - q0)
        seg = x[..., q0 * step:q0 * step + (c - 1) * step + span]
        parts.append(torch.matmul(seg.unfold(-1, span, step)[..., ::dilation],
                                  taps))
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=-1 if taps.dim() == 1 else -2)


def conv(x, h, mode: ConvModeType = ConvModeType.FULL, device=None):
    """True convolution of (..., n) with kernel (m,)."""
    mode = ConvModeType(mode)
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    h = as_tensor(h, dev)
    n, m = x.shape[-1], h.shape[-1]
    if mode == ConvModeType.FULL:
        pad = (m - 1, m - 1)
    elif mode == ConvModeType.SAME:
        # start offset m//2 - (1 if m even else 0) (conv_algorithm.c:236-242)
        start = m // 2 - (0 if m % 2 else 1)
        pad = (m - 1 - start, start)
    else:
        pad = (0, 0)
    xp = F.pad(x, pad)
    return window_product(xp, h.flip(0), xp.shape[-1] - m + 1)
