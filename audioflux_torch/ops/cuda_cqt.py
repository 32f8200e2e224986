"""The CQT's octaves in one kernel (``csrc/cqt.cu``), and its plain
PyTorch version.

For each octave of a CQT plan (its level of the 2:1 resample chain and its
slide), every padded rect-window frame's 512-point real transform times
the octave's complex kernel, scaled per bin and written into the complex
(..., num, T) output.  :func:`cqt_octaves` does all octaves in one launch
(``cqt_octaves_kernel``: the padding and the cut happen in its load, each
frame is one 256-point complex transform in registers split to the real
spectrum, and the product runs over each kernel row's run of consecutive
bins); :func:`cqt_octaves_ref` is the same as PyTorch code (the padding,
the frames, ``rfft``, four fp32 matrix products with the dense kernels,
the concatenation, scale and transpose), which ``CQTBase`` runs for the
calls the kernel does not take.

It replaces no TPU kernel (the JAX package's CQT at this length is XLA
code).  Its values are the plain version's within float32 rounding: the
transform and the sums over the bins round in another order.

:func:`supports` says which calls take it: a CUDA float32 input and a
plan of ``fft_length`` 512 whose octaves' slides are all at least 1 and
whose block's span of samples fits the kernel's shared memory.
``CQTBase.cqt`` and ``CQTBase._cqt_frames`` route by it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.observe import scope
from audioflux_torch.ops import _build, cuda_fft
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor
from audioflux_torch.ops.frame import frame_signal
from audioflux_torch.ops.pad import pad_signal
from audioflux_torch.types import PaddingModeType, PaddingPositionType

__all__ = ["FFT_LENGTH", "MAX_OCTAVES", "TILE", "SPAN_MAX", "OctaveKernels",
           "span", "supports", "octave_kernels", "cqt_octaves",
           "cqt_octaves_ref"]

FFT_LENGTH = 512        # the frame length the kernel takes
MAX_OCTAVES = 16        # the octaves one launch takes
TILE = 64               # output frames a block (cqt.cu kTile)
SPAN_MAX = 12288        # samples a block stages (cqt.cu kSpanMax)


class OctaveKernels(NamedTuple):
    """The octaves' complex CQT kernels (lowest octave first) in the two
    forms: ``planes``, each octave's dense (re, im) fp32 planes (bpo, fft
    / 2 + 1), which the plain version multiplies; and each row's run of
    consecutive bins, from its first nonzero to its last, which the kernel
    reads: ``meta`` (octaves, bpo, 3) int32 (first bin, length, offset
    into ``vals``), ``vals`` (the runs' total, 2) fp32 (re, im), and the
    kept bins [lo, hi) that the runs cover together."""
    planes: list
    meta: torch.Tensor
    vals: torch.Tensor
    lo: int
    hi: int


def span(slides, T: int) -> int:
    """Samples of a level that a block of the kernel stages: its most
    frames, min(:data:`TILE`, T), at the largest slide."""
    return (min(TILE, T) - 1) * max(slides) + FFT_LENGTH


def supports(x, fft_length: int, slides, T: int) -> bool:
    """Whether the kernel takes the octaves of ``x`` at ``T`` output
    frames: a CUDA float32 tensor, ``fft_length`` 512, at most
    :data:`MAX_OCTAVES` octaves, every octave's slide at least 1 and the
    :func:`span` at most :data:`SPAN_MAX` (at 64 frames, slides up to
    186)."""
    return (x.is_cuda and x.dtype == torch.float32
            and fft_length == FFT_LENGTH
            and 1 <= len(slides) <= MAX_OCTAVES and min(slides) >= 1
            and span(slides, T) <= SPAN_MAX)


def octave_kernels(kernels, device) -> OctaveKernels:
    """Both forms of the octaves' complex kernels (numpy complex64, (bpo,
    fft / 2 + 1) each, lowest octave first) on ``device``; each distinct
    kernel's planes are uploaded once."""
    up = {}
    for k in kernels:
        if id(k) not in up:
            up[id(k)] = (as_tensor(k.real, device), as_tensor(k.imag, device))
    bpo = kernels[0].shape[0]
    meta = np.zeros((len(kernels), bpo, 3), np.int32)
    vals, off, lo, hi = [], 0, None, None
    for o, k in enumerate(kernels):
        for r in range(bpo):
            nz = np.flatnonzero(k[r])
            if not nz.size:
                meta[o, r] = (0, 0, off)
                continue
            a, b = int(nz[0]), int(nz[-1]) + 1
            meta[o, r] = (a, b - a, off)
            vals.append(k[r, a:b])
            off += b - a
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)
    if lo is None:          # an all-zero bank: one bin, read by no row
        lo, hi = 0, 1
    meta[..., 0] = np.where(meta[..., 1] > 0, meta[..., 0], lo)
    v = (np.concatenate(vals) if vals else np.zeros(1, np.complex64))
    pairs = np.stack([v.real, v.imag], -1).astype(np.float32)
    return OctaveKernels([up[id(k)] for k in kernels],
                         torch.from_numpy(meta).to(device),
                         torch.from_numpy(pairs).to(device), lo, hi)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("cqt")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.af_cqt_octaves.argtypes = [p, p, p, i, ll, p, p, p, p, p, i, i, i, i,
                                   i, i, p]
    lib.af_cqt_octaves.restype = ctypes.c_int
    return lib


def cqt_octaves_ref(levels, slides, kernels: OctaveKernels, scale, *,
                    fft_length: int, T: int, t0: int = 0,
                    center: bool = True) -> torch.Tensor:
    """Plain version of :func:`cqt_octaves`, but ``levels`` yields the
    levels from the highest octave down (a generator may make each level
    once the octave above it is done, so one level and one octave's
    spectra are alive at a time).  Per octave the padded level
    (``pad_signal``, CENTER or RIGHT), its frames [t0, t0 + T) (those past
    the octave's last zero), ``rfft`` and the four fp32 products with the
    dense kernel; then the octaves side by side, the scale and the
    transpose."""
    pos = PaddingPositionType.CENTER if center else PaddingPositionType.RIGHT
    octaves = len(slides)
    blocks = [None] * octaves
    for o, x in zip(range(octaves - 1, -1, -1), levels):
        blocks[o] = _octave_ref(x, slides[o], kernels.planes[o], pos,
                                fft_length, T, t0)
    out = torch.cat(blocks, dim=-1) * scale
    return out.transpose(-1, -2).contiguous()


def _octave_ref(x, slide, kernel, pos, fft_length, T, t0):
    """One octave of :func:`cqt_octaves_ref`: (..., T, bpo) complex64."""
    kr, ki = kernel
    xp = pad_signal(x, fft_length, slide, pos, PaddingModeType.CONSTANT)
    hi = min(t0 + T, (xp.shape[-1] - fft_length) // slide + 1)
    if hi <= t0:
        return torch.zeros(x.shape[:-1] + (T, kr.shape[0]),
                           dtype=torch.complex64, device=x.device)
    seg = xp[..., t0 * slide:(hi - 1) * slide + fft_length]
    S = afft.rfft(frame_signal(seg, fft_length, slide), dim=-1)
    sr_, si_ = S.real, S.imag
    re = torch.matmul(sr_, kr.T) - torch.matmul(si_, ki.T)
    im = torch.matmul(si_, kr.T) + torch.matmul(sr_, ki.T)
    return F.pad(torch.complex(re, im), (0, 0, 0, t0 + T - hi))


def cqt_octaves(levels, slides, kernels: OctaveKernels, scale, *,
                fft_length: int, T: int, t0: int = 0,
                center: bool = True) -> torch.Tensor:
    """The CQT of every octave: ``levels[o]`` (..., n_o) fp32, octave o's
    level of the resample chain (o = 0 the lowest), framed at
    ``slides[o]``, CENTER padded (``center``; else RIGHT, continue mode);
    ``kernels`` the plan's :func:`octave_kernels`, ``scale`` (octaves * bpo,)
    fp32.  Returns complex64 (..., octaves * bpo, T): output frame t of
    octave o is its frame t0 + t, zero past its last.

    A CUDA tensor launches the kernel (sm_90 only, fft_length 512, the
    :func:`span` at most :data:`SPAN_MAX`) or raises; a CPU tensor takes
    the plain version."""
    with scope("af.kernel.cqt_octaves"):
        if not 1 <= len(levels) == len(slides) <= MAX_OCTAVES:
            raise ValueError(f"need 1 to {MAX_OCTAVES} levels and a slide "
                             f"each, got {len(levels)} and {len(slides)}")
        octaves, bpo = kernels.meta.shape[:2]
        if octaves != len(levels) or scale.shape != (octaves * bpo,):
            raise ValueError("the kernels and the scale need one entry an "
                             "octave and a row")
        lead = levels[0].shape[:-1]
        for x in levels:
            if x.dtype != torch.float32:
                raise TypeError(f"levels must be float32, got {x.dtype}")
            if x.shape[:-1] != lead or x.device != levels[0].device:
                raise ValueError("levels need one batch shape and device")
        if min(slides) < 1 or T < 0 or t0 < 0:
            raise ValueError(f"need slides >= 1, T >= 0 and t0 >= 0, got "
                             f"{list(slides)}, {T}, {t0}")
        dev = levels[0].device
        if dev.type == "cpu":
            return cqt_octaves_ref(levels[::-1], slides, kernels, scale,
                                   fft_length=fft_length, T=T, t0=t0,
                                   center=center)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if fft_length != FFT_LENGTH:
            raise ValueError(f"cqt_octaves needs fft_length {FFT_LENGTH} on "
                             f"the card, got {fft_length}")
        if span(slides, T) > SPAN_MAX:
            raise ValueError(f"a block's span of {span(slides, T)} samples "
                             f"passes {SPAN_MAX}: slides {list(slides)}")
        out = torch.empty(lead + (octaves * bpo, T, 2), dtype=torch.float32,
                          device=dev)
        if out.numel() == 0:
            return torch.view_as_complex(out)
        batch = out.numel() // (octaves * bpo * T * 2)
        rows = [x.reshape(batch, x.shape[-1]).contiguous() for x in levels]
        k = len(rows)
        ptrs = (ctypes.c_void_p * k)(*(r.data_ptr() for r in rows))
        lens = (ctypes.c_longlong * k)(*(r.shape[-1] for r in rows))
        sl = (ctypes.c_int * k)(*(int(s) for s in slides))
        sc = scale.contiguous()
        _build.launch(_lib().af_cqt_octaves, "cqt_octaves", dev, ptrs, lens,
                      sl, k, batch, kernels.meta.data_ptr(),
                      kernels.vals.data_ptr(), sc.data_ptr(),
                      cuda_fft.twiddle_table(FFT_LENGTH, dev).data_ptr(),
                      out.data_ptr(), bpo, T, t0,
                      fft_length // 2 if center else 0, kernels.lo,
                      kernels.hi)
        cqt_octaves.launches += 1
        return torch.view_as_complex(out)


cqt_octaves.launches = 0
