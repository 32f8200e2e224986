"""YIN from the clips to the pitch in one kernel (``csrc/fft_pow2.cu``
``yin_reg_kernel``), its plain PyTorch version, and the PyTorch tail of
YIN that both the plain version and ``mir.pitch_yin._yin_impl`` run.

The kernel is YIN's entry of the autocorrelation (``cuda_fft.
fft_autocorr_yin``: each frame staged straight from its clip, the
transform round trip in registers) with YIN's tail in its epilogue: the
frame's energies from a prefix sum of its squares, the difference
function, the CMND, and the first trough below the threshold with its
parabolic offset.  Per frame it writes the pitch, the CMND at the trough
and the CMND row, and nothing else: no frame, square, lag or scan reaches
device memory.  It replaces no TPU kernel (the JAX package's tail is XLA
code).  Its sums run in another order than ``torch.cumsum``, so its CMND
differs from the plain version's by float32 rounding, and a trough on the
threshold's knife edge may fall to the other side.

:func:`supports` says which calls take it: a CUDA float32 input,
``fft_length`` 2048 or 4096, and at least three CMND columns starting at a
lag of 1 or more.  ``PitchYIN.pitch`` routes by it; every other call keeps
``_yin_impl``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audioflux_torch.observe import scope
from audioflux_torch.ops import _build, cuda_fft
from audioflux_torch.ops.frame import cal_time_length, frame_signal

__all__ = ["supports", "parabolic_offsets", "first_trough", "yin_tail",
           "yin_pitch", "yin_pitch_ref"]

def supports(x, fft_length: int, min_index: int, max_index: int) -> bool:
    """Whether the kernel takes YIN of ``x``: a CUDA float32 tensor,
    ``fft_length`` 2048 or 4096, ``1 <= min_index`` and at least three
    CMND columns (``max_index - min_index >= 2``)."""
    return (x.is_cuda and x.dtype == torch.float32
            and fft_length in cuda_fft.REGISTER_N and 1 <= min_index
            and max_index - min_index >= 2)


def parabolic_offsets(yin: torch.Tensor) -> torch.Tensor:
    """The parabolic offset of every CMND column (``_pitch_yin.c``:462-494)
    from its neighbours, 0 where it exceeds 1 in magnitude and at the
    first and last column: (..., L) like ``yin``.  The kernel evaluates
    the same formula in the same order and roundings."""
    v1 = yin[..., :-2]
    v2 = yin[..., 1:-1]
    v3 = yin[..., 2:]
    offs = -(v3 - v1) / 2.0 / (2.0 * ((v1 + v3 - 2 * v2) / 2.0) + 1e-16)
    offs = torch.where(offs.abs() <= 1.0, offs, torch.zeros_like(offs))
    return F.pad(offs, (1, 1))


def yin_tail(frames, acf, *, auto_length, min_index, max_index, samplate,
             thresh):
    """YIN from the frames (..., T, n) and their autocorrelation at lags
    ``auto_length`` on (..., T, n - auto_length) to the pitch: (fre, value,
    yin, interp), the per-frame pitch and CMND value at the first trough
    below ``thresh`` (0 where none), the CMND rows over lags ``min_index
    .. max_index`` and their parabolic offsets."""
    diff_length = frames.shape[-1] - auto_length
    acf = torch.where(acf.abs() >= 1e-6, acf, torch.zeros_like(acf))

    # frame energies over sliding auto_length windows (:372-390)
    csum = torch.cumsum(frames * frames, dim=-1)
    e2 = csum[..., auto_length:] - csum[..., :diff_length]
    e2 = torch.where(e2.abs() >= 1e-6, e2, torch.zeros_like(e2))

    diff = e2[..., :1] + e2 - 2.0 * acf  # (..., T, diff)

    # CMND (:398-430)
    num = diff[..., min_index:max_index + 1]
    csum_d = torch.cumsum(diff[..., 1:max_index + 1], dim=-1)
    mean = csum_d / torch.arange(1, max_index + 1, dtype=torch.float32,
                                 device=frames.device)
    den = mean[..., min_index - 1:max_index]
    yin = num / (den + 1e-16)  # (..., T, yin_length)

    interp = parabolic_offsets(yin)
    fre, value = first_trough(yin, interp, min_index=min_index,
                              samplate=samplate, thresh=thresh)
    return fre, value, yin, interp


def first_trough(yin, interp, *, min_index, samplate, thresh):
    """The pitch and CMND value at each row's first trough below
    ``thresh`` (:520-548), 0 and 0 where there is none: the first column
    needs a strict rise after it, an interior column a strict fall before
    it and no fall after it, the last column never counts.  ``interp``:
    the rows' parabolic offsets."""
    below = yin < thresh
    is_trough = torch.cat(
        [(yin[..., :1] < yin[..., 1:2]) & below[..., :1],
         (yin[..., 1:-1] <= yin[..., 2:]) & (yin[..., 1:-1] < yin[..., :-2])
         & below[..., 1:-1],
         torch.zeros_like(below[..., -1:])], dim=-1)
    any_t = is_trough.any(dim=-1)
    # argmax of an integer tensor returns the first of several equal maxima
    t_idx = torch.argmax(is_trough.to(torch.uint8), dim=-1)
    off = torch.gather(interp, -1, t_idx[..., None])[..., 0]
    fre = samplate / (min_index + t_idx + off)
    fre = torch.where(any_t, fre, torch.zeros_like(fre))
    value = torch.gather(yin, -1, t_idx[..., None])[..., 0]
    value = torch.where(any_t, value, torch.zeros_like(value))
    return fre, value


def yin_pitch_ref(x: torch.Tensor, *, fft_length: int, slide_length: int,
                  auto_length: int, min_index: int, max_index: int,
                  samplate: float, thresh: float):
    """Plain version of :func:`yin_pitch`: the frames, their
    autocorrelation (``cuda_fft.fft_autocorr_yin_ref``) and
    :func:`yin_tail`."""
    frames = frame_signal(x, fft_length, slide_length)
    acf = cuda_fft.fft_autocorr_yin_ref(x, fft_length, slide_length,
                                        auto_length)
    fre, value, yin, _ = yin_tail(frames, acf, auto_length=auto_length,
                                  min_index=min_index, max_index=max_index,
                                  samplate=samplate, thresh=thresh)
    return fre, value, yin


def _check(x, fft_length, slide_length, auto_length, min_index, max_index):
    """The wrapper's checks; returns the frame count."""
    if fft_length not in cuda_fft.REGISTER_N:
        raise ValueError(f"yin_pitch needs fft_length in "
                         f"{cuda_fft.REGISTER_N}, got {fft_length}")
    if not 0 <= auto_length < fft_length or slide_length < 1:
        raise ValueError(f"need 0 <= auto_length < fft_length and "
                         f"slide_length >= 1, got {auto_length}, "
                         f"{slide_length}")
    if not 1 <= min_index <= max_index - 2 < fft_length - auto_length - 2:
        raise ValueError(f"need 1 <= min_index, min_index + 2 <= max_index "
                         f"< fft_length - auto_length, got {min_index}, "
                         f"{max_index}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    frames = cal_time_length(x.shape[-1], fft_length, slide_length)
    if frames <= 0:
        raise ValueError(f"signal too short to frame: n={x.shape[-1]} "
                         f"fft_length={fft_length}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return frames


def yin_pitch(x: torch.Tensor, *, fft_length: int, slide_length: int,
              auto_length: int, min_index: int, max_index: int,
              samplate: float, thresh: float):
    """YIN of every frame of fp32 clips ``x`` (..., samples), frame t at
    ``x[..., t * slide_length:][:fft_length]`` (the frames that fit) ->
    (fre, value, yin): the pitch and the CMND value at each frame's first
    trough below ``thresh`` (0 where none), each (..., T), and the CMND
    rows over lags ``min_index .. max_index``, (..., T, max_index -
    min_index + 1).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.yin_pitch"):
        frames = _check(x, fft_length, slide_length, auto_length, min_index,
                        max_index)
        if not x.is_cuda:
            return yin_pitch_ref(x, fft_length=fft_length,
                                 slide_length=slide_length,
                                 auto_length=auto_length,
                                 min_index=min_index, max_index=max_index,
                                 samplate=samplate, thresh=thresh)
        lead = x.shape[:-1] + (frames,)
        fre = x.new_empty(lead)
        value = x.new_empty(lead)
        yin = x.new_empty(lead + (max_index - min_index + 1,))
        if yin.numel() == 0:
            return fre, value, yin
        samples = x.shape[-1]
        x2 = x.reshape(-1, samples).contiguous()
        _build.launch(cuda_fft._lib().af_fft_pow2_yin_pitch, "yin_pitch",
                      x.device, x2.data_ptr(), fre.data_ptr(),
                      value.data_ptr(), yin.data_ptr(),
                      cuda_fft.twiddle_table(fft_length, x.device).data_ptr(),
                      x2.shape[0], samples, frames, slide_length, auto_length,
                      min_index, max_index, thresh, samplate,
                      fft_length.bit_length() - 1)
        yin_pitch.launches += 1
        return fre, value, yin


yin_pitch.launches = 0
