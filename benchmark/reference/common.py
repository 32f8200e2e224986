"""Pieces the plain references share: the precision a reference runs in,
the analysis windows, the mel filter bank, the DCT-II matrix, framing and
overlap-add.

Plain numpy and torch.  The formulas follow the published audioFlux C
sources (``flux_window.c``, ``auditory_filterBank.c``, ``fft_algorithm.c``,
``stft_algorithm.c``); nothing here is taken from the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRECISIONS = ("float64", "tf32", "bf16")


class Precision:
    """How a reference computes.

    ``float64`` is the reference proper.  ``tf32`` and ``bf16`` are the
    controls: float32 storage with every matrix product's operands rounded
    to TF32 (10 mantissa bits, products accumulated in float32, which is
    what a TF32 tensor-core product computes), or every intermediate
    tensor rounded to bfloat16 as it is stored (the transforms themselves
    run in float32 on bfloat16-rounded operands and their results are
    rounded again).
    """

    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as this precision stores it."""
        if self.name != "bf16":
            return t
        if t.is_complex():
            return torch.complex(self.q(t.real), self.q(t.imag))
        return t.to(torch.bfloat16).to(t.dtype)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return self.q(torch.matmul(a, b))


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits (nearest, ties to
    even)."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def fft_window(kind: str, n: int) -> np.ndarray:
    """The periodic analysis window of ``n`` samples (float64)."""
    k = np.arange(n, dtype=np.float64)
    c = np.cos(2.0 * np.pi * k / n)
    if kind == "hann":
        return 0.5 - 0.5 * c
    if kind == "hamm":
        return 0.54 - 0.46 * c
    raise ValueError(f"unknown window {kind!r}")


def _linspace_f32(start, stop, length):
    """float32 ``start + i * step`` as the C library fills its grids."""
    start = np.float32(start)
    step = np.float32((np.float32(stop) - start) / np.float32(max(length - 1, 1)))
    return (start + np.arange(length, dtype=np.float32) * step).astype(np.float32)


def mel_filter_bank(num: int, n_fft: int, samplate: int, low_fre: float = 0.0,
                    high_fre: float | None = None) -> np.ndarray:
    """(num, n_fft // 2 + 1) mel bank, slaney-style triangles, no
    normalisation: band edges equally spaced on ``2595 log10(1 + f/700)``
    in float32, each edge's bin the first grid frequency above it.  The C
    library fills one flat row-major buffer, so a last band whose falling
    slope runs past the row spills into the next row; the same buffer is
    filled here."""
    f32 = np.float32
    if high_fre is None:
        high_fre = samplate / 2.0
    m_len = n_fft // 2 + 1
    lo = f32(f32(2595) * np.log10(f32(1) + f32(low_fre) / f32(700)))
    hi = f32(f32(2595) * np.log10(f32(1) + f32(high_fre) / f32(700)))
    mels = _linspace_f32(lo, hi, num + 2)
    fre = (f32(700) * (np.power(f32(10), mels / f32(2595)) - f32(1))).astype(f32)
    grid = _linspace_f32(0.0, samplate - samplate / float(n_fft), n_fft)
    bins = np.searchsorted(grid, fre, side="right")
    grid64, fre64 = grid.astype(np.float64), fre.astype(np.float64)
    widths = np.diff(fre64)
    flat = np.zeros(num * m_len + n_fft)
    for i in range(num):
        a, b, c = bins[i], bins[i + 1], bins[i + 2]
        j = np.arange(a, b)
        flat[i * m_len + j] = (grid64[j] - fre64[i]) / widths[i]
        j = np.arange(b, c)
        flat[i * m_len + j] = (fre64[i + 2] - grid64[j]) / widths[i + 1]
    # the C library keeps the bank in float32
    return flat[:num * m_len].reshape(num, m_len).astype(np.float32)


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II, row k applied to a length-n vector (float64)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    m[0] *= math.sqrt(1.0 / n)
    m[1:] *= math.sqrt(2.0 / n)
    return m


def n_frames(n: int, n_fft: int, slide: int) -> int:
    """Frames of an unpadded signal of ``n`` samples."""
    return (n - n_fft) // slide + 1 if n >= n_fft else 0


def frames(x: torch.Tensor, n_fft: int, slide: int) -> torch.Tensor:
    """(n,) -> (T, n_fft) frames, copied."""
    t = n_frames(x.shape[-1], n_fft, slide)
    idx = (torch.arange(t, device=x.device)[:, None] * slide
           + torch.arange(n_fft, device=x.device)[None, :])
    return x[idx]


def overlap_add(fr: torch.Tensor, slide: int) -> torch.Tensor:
    """(T, n_fft) frames -> ((T - 1) * slide + n_fft,) sum of the frames
    placed ``slide`` apart."""
    t, n_fft = fr.shape
    if n_fft % slide:
        raise ValueError("overlap_add needs slide | n_fft")
    out = fr.new_zeros((t - 1) * slide + n_fft)
    for j in range(n_fft // slide):
        out[j * slide:j * slide + t * slide] += (
            fr[:, j * slide:(j + 1) * slide].reshape(-1))
    return out


def frame_blocks(t: int, rows: int):
    """[start, stop) spans of at most ``rows`` frames covering ``t``."""
    return [(s, min(s + rows, t)) for s in range(0, t, rows)]


def peak_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap over the rows of ``max |got - ref| / max |ref|`` (the
    leading axis indexes the rows: clips, recordings)."""
    g = got.reshape(got.shape[0], -1).to(torch.float64)
    r = ref.reshape(ref.shape[0], -1).to(torch.float64)
    gap = (g - r).abs().amax(dim=1)
    peak = r.abs().amax(dim=1).clamp_min(1e-300)
    return float((gap / peak).max())
