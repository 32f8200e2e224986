"""The bytes and operations of one ``mel_mfcc_32k`` call: framing,
window, real FFT, power, mel bank, log10 and DCT over (clips, n) audio.

Bytes: the samples read once, the mel and cepstral outputs written once
(float32).  Operations a frame: 2.5 n log2 n for the transform, two a
nonzero weight of the mel bank, one log10 a band, two a DCT weight.  The
count is of the work, not of a kernel, so it reads the same whatever
computes the call."""

from __future__ import annotations

import functools
import math

from benchmark.reference import common


@functools.lru_cache(maxsize=None)
def bank_nnz(num: int, n_fft: int, samplate: int) -> int:
    return int((common.mel_filter_bank(num, n_fft, samplate) != 0).sum())


def need(cfg: dict, clips: int, n: int):
    """(bytes, operations) of one call on ``clips`` clips of ``n``
    samples."""
    p = cfg["plans"]["mel"]
    n_fft, num = 1 << p["radix2_exp"], p["num"]
    cc = cfg["entry_args"]["cc_num"]
    t = common.n_frames(n, n_fft, p["slide_length"])
    n_bytes = 4 * (clips * n + clips * (num + cc) * t)
    per_frame = (2.5 * n_fft * math.log2(n_fft)
                 + 2 * bank_nnz(num, n_fft, p["samplate"]) + num + 2 * cc * num)
    return n_bytes, clips * t * per_frame
