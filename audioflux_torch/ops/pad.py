"""Signal padding with the reference's position x mode semantics.

Counterpart of ``audioflux_tpu/ops/pad.py`` (reference:
``src/stft_algorithm.c:601-694`` and ``src/vector/flux_vectorOp.c:613-790``).

With padding enabled the reference first *drops the tail* ``n % slide``
samples, then pads ``fft_length`` total samples around the remainder:

- CENTER: ``fft//2`` on the left, ``fft - fft//2`` on the right
- LEFT:   ``fft`` on the left
- RIGHT:  ``fft`` on the right

Modes: CONSTANT (value1 left / value2 right for CENTER, value1 otherwise),
REFLECT (no edge repeat), WRAP.

Quirk reproduced for parity: for LEFT/RIGHT constant padding the reference
passes the float pad value into a function that declares it ``int``
(flux_vectorOp.c:641-651), so it is truncated toward zero; only CENTER
keeps the float values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from audioflux_torch.types import PaddingModeType, PaddingPositionType

__all__ = ["pad_signal"]


def pad_signal(x: torch.Tensor, fft_length: int, slide_length: int,
               position: PaddingPositionType = PaddingPositionType.CENTER,
               mode: PaddingModeType = PaddingModeType.CONSTANT,
               value1: float = 0.0, value2: float = 0.0) -> torch.Tensor:
    """Pad the last axis per the reference STFT padding semantics.

    Returns the padded signal of length
    ``(n // slide) * slide + fft_length``.
    """
    n = x.shape[-1]
    x = x[..., :(n // slide_length) * slide_length]

    if position == PaddingPositionType.CENTER:
        left, right = fft_length // 2, fft_length - fft_length // 2
    elif position == PaddingPositionType.LEFT:
        left, right = fft_length, 0
    else:  # RIGHT
        left, right = 0, fft_length

    if mode == PaddingModeType.CONSTANT:
        if position == PaddingPositionType.CENTER:
            return torch.cat(
                [x.new_full(x.shape[:-1] + (left,), float(value1)), x,
                 x.new_full(x.shape[:-1] + (right,), float(value2))], dim=-1)
        # the reference declares the value as int: truncate toward zero
        return F.pad(x, (left, right), value=float(math.trunc(value1)))
    if mode == PaddingModeType.REFLECT:
        torch_mode = "reflect"
    elif mode == PaddingModeType.WRAP:
        torch_mode = "circular"
    else:
        raise ValueError(f"unsupported padding mode {mode!r}")
    # the non-constant modes of F.pad want (batch, channel, n)
    lead = x.shape[:-1]
    out = F.pad(x.reshape(1, -1, x.shape[-1]), (left, right), mode=torch_mode)
    return out.reshape(lead + (out.shape[-1],))
