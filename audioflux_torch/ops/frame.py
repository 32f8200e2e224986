"""Frame extraction and frame-count math (bit-exact with the reference).

Reference formulas (``src/stft_algorithm.c:225-262, 805-835``):

- no padding: ``time_length = (n - fft_length) // slide_length + 1``
  (requires ``n >= fft_length``)
- padding:    ``time_length = n // slide_length + 1`` over the padded buffer
- inverse:    ``data_length = (time_length - 1) * slide_length + fft_length``
"""

from __future__ import annotations

import torch

__all__ = ["cal_time_length", "cal_data_length", "frame_signal"]


def cal_time_length(data_length: int, fft_length: int, slide_length: int,
                    is_pad: bool = False) -> int:
    if not is_pad:
        if data_length < fft_length:
            return 0
        return (data_length - fft_length) // slide_length + 1
    if data_length <= 0:
        return 0
    return data_length // slide_length + 1


def cal_data_length(time_length: int, fft_length: int, slide_length: int) -> int:
    return (time_length - 1) * slide_length + fft_length


def frame_signal(x: torch.Tensor, fft_length: int, slide_length: int,
                 n_frames: int | None = None) -> torch.Tensor:
    """Overlapping frames of the last axis: (..., n) -> (..., T, fft_length).

    A strided view (``Tensor.unfold``), no copy; ``n_frames`` defaults to
    the no-padding frame count and may only shorten it.
    """
    n = x.shape[-1]
    if n_frames is None:
        n_frames = cal_time_length(n, fft_length, slide_length, is_pad=False)
    if n_frames <= 0:
        raise ValueError(
            f"signal too short to frame: n={n} fft_length={fft_length}")
    return x.unfold(-1, fft_length, slide_length)[..., :n_frames, :]
