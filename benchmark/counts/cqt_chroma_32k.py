"""The bytes and operations of one ``cqt_chroma_32k`` CQT call on (rows, n)
clips, counted from the work and not from the kernels, so that they read
the same whatever computes the call.

- Bytes (``cqt_need``): the audio read once (4 B a sample), each
  resampled level written once and read once (4 B a sample each way;
  n / 2 + n / 4 + ... samples), and the complex output written once (8 B
  a cell of num x T).  Frames, spectra and the kernel are intermediates
  or small, and are not counted.
- Operations: each octave's T frames a clip through a real transform of
  ``fft_length`` points at ``2.5 N log2 N``; the kernel product over the
  nonzeros of the reference's own bank alone, 8 a complex nonzero (a
  complex multiply and add) a frame; the 2:1 resampler at 2 a tap (its
  nonzero taps) an output sample.  The chroma fold is not counted.

No implementation of this work reads over 100%: the count is of the
work, not of the program's code, which runs the kernel product dense and
copies the frames.  At the cell's 128 clips of 960,000 samples the
bound is set by the operations (about 100 GFLOP, 1.49 ms, against 2.10
GB, 0.63 ms).
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.cqt_chroma_32k import Plan


def cqt_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of the CQT of ``rows`` clips of ``n``
    samples."""
    p = Plan(cfg["plans"]["cqt"], cfg["plans"]["chroma"])
    t = n // p.slide + 1
    levels = sum(n >> d for d in range(1, p.octaves))
    n_bytes = 4 * rows * n + 8 * rows * levels + 8 * rows * p.num * t
    frames = p.octaves * rows * t
    fft = 2.5 * p.fft_length * math.log2(p.fft_length)
    product = 8 * int(np.count_nonzero(p.kernel))
    taps = int(np.count_nonzero(p.left) + np.count_nonzero(p.right))
    resample = 2 * taps * rows * levels
    return n_bytes, frames * (fft + product) + resample
