"""The streaming tail of the STFT family (the rest of the TPU package's
``transforms/stft.py`` is not ported yet)."""

from __future__ import annotations

import torch

__all__ = ["TailCarry"]


class TailCarry:
    """The stftObj ``isContinue`` cross-call tail state
    (stft_algorithm.c:474-600, non-pad path).

    Each :meth:`feed` consumes ``tail + chunk``; when at least one frame
    fits it returns the sample buffer covering the completed frames and
    carries ``(total - fft) % slide + (fft - slide)`` samples forward;
    otherwise it accumulates the chunk and returns ``None``.  When
    ``slide > fft`` the carry is NEGATIVE — that many samples of the next
    chunk are skipped, exactly as the C's ``tailDataLength < 0`` branch.

    Works on ``(..., n)`` tensors on any device (the C streams 1-D; leading
    dims must stay consistent across calls).
    """

    def __init__(self, fft_length: int, slide_length: int):
        self.fft_length = int(fft_length)
        self.slide_length = int(slide_length)
        self.reset()

    def reset(self):
        self.tail = None
        self.tail_len = 0

    def cal_time_length(self, data_length: int) -> int:
        """Frames the next feed of ``data_length`` samples would emit
        (stftObj_calTimeLength adds the pending tail, :243)."""
        total = self.tail_len + int(data_length)
        if total < self.fft_length:
            return 0
        return (total - self.fft_length) // self.slide_length + 1

    def feed(self, x: torch.Tensor):
        fft, slide = self.fft_length, self.slide_length
        if self.tail_len < 0:
            buf = x[..., -self.tail_len:]
        elif self.tail_len:
            buf = torch.cat([self.tail, x], dim=-1)
        else:
            buf = x
        total = self.tail_len + x.shape[-1]
        if total < fft:
            self.tail = buf.clone()
            self.tail_len = total
            return None
        tail_len = (total - fft) % slide + (fft - slide)
        self.tail = buf[..., total - tail_len:total].clone() if tail_len > 0 else None
        self.tail_len = tail_len
        # the FULL tail+chunk buffer, like the C's curDataArr/validDataArr
        return buf
