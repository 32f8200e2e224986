"""HPSS's stages around the median: the CUDA kernels of ``csrc/hpss.cu``
and their plain PyTorch versions.

* :func:`hpss_magnitude`: the magnitude |X| of every frame's spectrum, the
  bins 0..n/2, (..., T, n/2 + 1): the input of both medians;
* :func:`hpss_resynth`: the soft masks h^2 / (h^2 + p^2) and p^2 / (h^2 +
  p^2) of the two medians applied to every frame's spectrum, both inverse
  transforms at once, the window, the overlap-add and the window-energy
  norm: (harmonic, percussive), each (..., (T - 1) * slide + n).

The kernels recompute each frame's spectrum from the signal, so no
spectrum, mask or frame is kept in device memory between or inside them.
They replace no TPU kernel (the JAX package's HPSS is XLA code); their
domain is :func:`supports`.  The plain versions are the port's HPSS as it
was written in PyTorch: ``ops.fft`` (the FFT kernels on the card) and
``transforms.stft._ola_frames``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audioflux_torch.observe import scope, setup_table
from audioflux_torch.ops import _build
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.cuda_fft import twiddle_table
from audioflux_torch.ops.frame import cal_time_length, frame_signal
from audioflux_torch.transforms.stft import _ola_frames

__all__ = ["supports", "hpss_magnitude", "hpss_magnitude_ref",
           "hpss_resynth", "hpss_resynth_ref"]

FFT_N = (2048, 4096)      # the kernels' transform lengths
HOPS = (4, 64)            # the least and most frames over one sample


def supports(x: torch.Tensor, fft_length: int, slide_length: int) -> bool:
    """Whether the kernels take HPSS of ``x``: a CUDA float32 tensor,
    ``fft_length`` 2048 or 4096, ``fft_length / slide_length`` a whole
    number in 4..64, and at least one frame."""
    return (x.is_cuda and x.dtype == torch.float32 and fft_length in FFT_N
            and slide_length > 0 and fft_length % slide_length == 0
            and HOPS[0] <= fft_length // slide_length <= HOPS[1]
            and x.shape[-1] >= fft_length)


@functools.lru_cache(maxsize=None)
@setup_table
def _lib():
    lib = _build.load("hpss")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.af_hpss_magnitude.argtypes = [p, ll, ll, i, i, i, p, p, p, p]
    lib.af_hpss_magnitude.restype = i
    lib.af_hpss_resynth.argtypes = [p, ll, ll, i, i, i, p, p, p, p, p, p, ll,
                                    p]
    lib.af_hpss_resynth.restype = i
    return lib


def _spectrum(x, window, fft_length, slide_length):
    """(..., T, n) complex: every frame's windowed spectrum, all n bins."""
    frames = frame_signal(x, fft_length, slide_length)
    return afft.fft(frames * window, dim=-1)


def hpss_magnitude_ref(x: torch.Tensor, window: torch.Tensor, *,
                       fft_length: int, slide_length: int) -> torch.Tensor:
    """Plain version of :func:`hpss_magnitude`."""
    Z = _spectrum(x, window, fft_length, slide_length)
    return Z[..., :fft_length // 2 + 1].abs().contiguous()


def hpss_resynth_ref(x: torch.Tensor, window: torch.Tensor, h: torch.Tensor,
                     p: torch.Tensor, *, fft_length: int, slide_length: int):
    """Plain version of :func:`hpss_resynth`."""
    m = fft_length // 2 + 1
    Z = _spectrum(x, window, fft_length, slide_length)
    h2, p2 = h * h, p * p
    denom = torch.clamp(h2 + p2, min=1e-16)

    # the masks are hermitian-symmetric (M[n-k] = M[k]): both extend to
    # all n bins by a mirror, and both resyntheses run as one inverse
    # transform, ifft((Mh + i*Mp) * X) = h_frames + i*p_frames
    def mirror(M):
        return torch.cat([M, M[..., 1:m - 1].flip(-1)], dim=-1)

    masks = torch.complex(mirror(h2 / denom), mirror(p2 / denom))
    y = _ola_frames(afft.ifft(masks * Z, dim=-1), window,
                    fft_length=fft_length, slide_length=slide_length,
                    method_type=0)
    return y.real, y.imag


def _check(x, window, fft_length, slide_length):
    """The checks both wrappers make; returns the frame count."""
    if fft_length not in FFT_N:
        raise ValueError(f"HPSS kernels need fft_length in {FFT_N}, got "
                         f"{fft_length}")
    if (slide_length <= 0 or fft_length % slide_length
            or not HOPS[0] <= fft_length // slide_length <= HOPS[1]):
        raise ValueError(f"HPSS kernels need fft_length / slide_length a "
                         f"whole number in {HOPS[0]}..{HOPS[1]}, got "
                         f"{fft_length} / {slide_length}")
    for name, t in (("x", x), ("window", window)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x and window must share a device")
    if tuple(window.shape) != (fft_length,) or not window.is_contiguous():
        raise ValueError(f"window must be a contiguous ({fft_length},), got "
                         f"{tuple(window.shape)}")
    frames = cal_time_length(x.shape[-1], fft_length, slide_length)
    if frames <= 0:
        raise ValueError(f"signal too short to frame: n={x.shape[-1]} "
                         f"fft_length={fft_length}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return frames


def hpss_magnitude(x: torch.Tensor, window: torch.Tensor, *,
                   fft_length: int, slide_length: int) -> torch.Tensor:
    """|rfft(frame * window)| of every frame of fp32 signals ``x`` (...,
    samples): frame t is ``x[..., t * slide_length:][:fft_length]`` (the
    frames that fit) -> (..., T, fft_length / 2 + 1).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.hpss_magnitude"):
        frames = _check(x, window, fft_length, slide_length)
        if not x.is_cuda:
            return hpss_magnitude_ref(x, window, fft_length=fft_length,
                                      slide_length=slide_length)
        samples = x.shape[-1]
        x2 = x.reshape(-1, samples).contiguous()
        mag = x.new_empty(x.shape[:-1] + (frames, fft_length // 2 + 1))
        if mag.numel() == 0:
            return mag
        _build.launch(_lib().af_hpss_magnitude, "hpss_magnitude", x.device,
                      x2.data_ptr(), x2.shape[0], samples, frames,
                      slide_length, fft_length.bit_length() - 1,
                      window.data_ptr(),
                      twiddle_table(fft_length, x.device).data_ptr(),
                      mag.data_ptr())
        hpss_magnitude.launches += 1
        return mag


def hpss_resynth(x: torch.Tensor, window: torch.Tensor, h: torch.Tensor,
                 p: torch.Tensor, *, fft_length: int, slide_length: int):
    """HPSS's resynthesis of fp32 signals ``x`` (..., samples) from the two
    medians ``h`` and ``p`` of :func:`hpss_magnitude` (..., T,
    fft_length / 2 + 1): masks Mh = h^2 / max(h^2 + p^2, 1e-16) and Mp
    likewise, each frame's spectrum times Mh + i Mp, one inverse transform,
    the window, the overlap-add and the division by the window-energy norm
    (1 where the norm is under 1e-6) -> (harmonic, percussive), each (...,
    (T - 1) * slide_length + fft_length).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.hpss_resynth"):
        frames = _check(x, window, fft_length, slide_length)
        shape = x.shape[:-1] + (frames, fft_length // 2 + 1)
        for name, t in (("h", h), ("p", p)):
            if t.dtype != torch.float32 or t.device != x.device:
                raise TypeError(f"{name} must be float32 on {x.device}")
            if t.shape != shape:
                raise ValueError(f"{name} must be {tuple(shape)}, got "
                                 f"{tuple(t.shape)}")
        if not x.is_cuda:
            return hpss_resynth_ref(x, window, h, p, fft_length=fft_length,
                                    slide_length=slide_length)
        return _resynth(x, window, h, p, fft_length, slide_length)


def _resynth(x, window, h, p, fft_length, slide_length, run=0):
    """Launch the back end on checked CUDA inputs.  ``run``: the slabs of
    output a group of threads makes (0: the launch sizes the runs so that
    one round of the card's resident groups covers the batch).  The
    outputs are the same bit for bit for every run; tests pass others."""
    frames, samples = h.shape[-2], x.shape[-1]
    x2 = x.reshape(-1, samples).contiguous()
    h, p = h.contiguous(), p.contiguous()
    out_len = (frames - 1) * slide_length + fft_length
    out_h = x.new_empty(x.shape[:-1] + (out_len,))
    out_p = torch.empty_like(out_h)
    if out_h.numel() == 0:
        return out_h, out_p
    _build.launch(_lib().af_hpss_resynth, "hpss_resynth", x.device,
                  x2.data_ptr(), x2.shape[0], samples, frames, slide_length,
                  fft_length.bit_length() - 1, window.data_ptr(),
                  twiddle_table(fft_length, x.device).data_ptr(),
                  h.data_ptr(), p.data_ptr(), out_h.data_ptr(),
                  out_p.data_ptr(), run)
    hpss_resynth.launches += 1
    return out_h, out_p


hpss_magnitude.launches = 0
hpss_resynth.launches = 0
