"""The bytes and operations of one ``cwt_synsq_32k`` call on (rows, n)
clips, counted from the work and not from the kernels, so that they read
the same whatever computes the call.

- The CWT (``cwt_need``): the samples read once (float32), W written once
  (complex64, 8 B a cell) and the bank read once (float32, num rows of the
  padded length N = n + 2 pad); a real forward transform of N points at
  2.5 N log2 N and ``num`` complex inverses at 5 N log2 N each, a clip.
  At the cell's 256 clips the bytes bound (1.70 ms) is above the
  operations bound (1.69 ms), so a kernel that skips the bank's zero
  rows still cannot read over 100%.
- The squeeze (``synsq_need``): W read once and S written once, 16 B a
  cell.  Its operations (the phase, the unwrap, the bin, the sums) are not
  counted, so a share of this bound is a lower bound; the int32 bin map
  between the two steps is the program's own and no part of the need.
"""

from __future__ import annotations

import math

from benchmark.reference.cwt_synsq_32k import pad_length


def cwt_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of the CWT of ``rows`` clips of ``n``
    samples."""
    c = cfg["plans"]["cwt"]
    num = c["num"]
    big = n + 2 * pad_length(n, c["is_padding"])
    log_n = math.log2(big)
    n_bytes = 4 * rows * n + 8 * rows * num * n + 4 * num * big
    ops = rows * (2.5 * big * log_n + num * 5 * big * log_n)
    return n_bytes, ops


def synsq_need(cfg: dict, rows: int, n: int):
    """(bytes, operations) of the squeeze of ``rows`` clips' CWT of ``n``
    samples; operations not counted (0)."""
    return 16 * rows * cfg["plans"]["synsq"]["num"] * n, 0.0
