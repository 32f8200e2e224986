"""FFT entry points with a kernel tier for mid-size transforms.

Counterpart of ``audioflux_tpu/ops/fft.py``.  Two tiers:

* pow2 2048 <= n <= 32768: ``ops.cuda_fft.fft_fwd`` / ``fft_inv`` — the
  hand-written CUDA kernels for a CUDA tensor, their plain versions for a
  CPU tensor;
* everything else: ``torch.fft``.

``exact=True`` skips the kernel tier: log-magnitude cepstral consumers
amplify a kernel's small error on near-zero bins through log() into argmax
flips, so they pin ``torch.fft``.  (The TPU package's dense-DFT tier for
n < 2048 worked around that backend's FFT and has no counterpart.)
"""

from __future__ import annotations

import torch

from audioflux_torch.ops import cuda_fft

__all__ = ["rfft", "irfft", "fft", "ifft", "fft_parts", "ifft_parts"]


def _kernel_tier(n: int, exact: bool) -> bool:
    return cuda_fft.supports(n) and not exact


def _prep(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Move ``dim`` last and zero-pad or trim it to ``n``."""
    x = x.movedim(dim, -1)
    ln = x.shape[-1]
    if n < ln:
        x = x[..., :n]
    elif n > ln:
        x = torch.nn.functional.pad(x, (0, n - ln))
    return x


def rfft(x: torch.Tensor, n=None, dim=-1, exact=False) -> torch.Tensor:
    ln = n if n is not None else x.shape[dim]
    if not _kernel_tier(ln, exact):
        rfft.library_calls += 1
        return torch.fft.rfft(x, n=n, dim=dim)
    # rows shorter than n are not padded: the kernel reads the live
    # samples alone
    v = _prep(x, min(ln, x.shape[dim]), dim).to(torch.float32).contiguous()
    yr, yi = cuda_fft.fft_fwd(v, bins=ln // 2 + 1, n=ln)
    return torch.complex(yr, yi).movedim(-1, dim)


rfft.library_calls = 0   # calls that took torch.fft (off the kernel tier)


def fft(x: torch.Tensor, n=None, dim=-1, exact=False) -> torch.Tensor:
    ln = n if n is not None else x.shape[dim]
    if not _kernel_tier(ln, exact):
        return torch.fft.fft(x, n=n, dim=dim)
    if x.is_complex():
        v = _prep(x, ln, dim)
        yr, yi = cuda_fft.fft_fwd(v.real.to(torch.float32).contiguous(),
                                  v.imag.to(torch.float32).contiguous())
    else:               # real rows shorter than n: only the live samples
        v = _prep(x, min(ln, x.shape[dim]), dim)
        yr, yi = cuda_fft.fft_fwd(v.to(torch.float32).contiguous(), n=ln)
    return torch.complex(yr, yi).movedim(-1, dim)


def irfft(x: torch.Tensor, n=None, dim=-1, exact=False) -> torch.Tensor:
    ln = n if n is not None else 2 * (x.shape[dim] - 1)
    if not _kernel_tier(ln, exact):
        return torch.fft.irfft(x, n=n, dim=dim)
    # the half spectrum as it is: the kernel ignores the imaginary parts of
    # the DC and Nyquist bins, torch.fft.irfft's convention on
    # hermitian-inconsistent input
    v = _prep(x, ln // 2 + 1, dim)
    vr = (v.real if v.is_complex() else v).to(torch.float32).contiguous()
    vi = (v.imag.to(torch.float32).contiguous() if v.is_complex()
          else torch.zeros_like(vr))
    out, _ = cuda_fft.fft_inv(vr, vi, n=ln)
    return out.movedim(-1, dim)


def ifft(x: torch.Tensor, n=None, dim=-1, exact=False) -> torch.Tensor:
    ln = n if n is not None else x.shape[dim]
    if not _kernel_tier(ln, exact):
        return torch.fft.ifft(x, n=n, dim=dim)
    v = _prep(x, ln, dim)
    if v.is_complex():
        vr = v.real.to(torch.float32).contiguous()
        vi = v.imag.to(torch.float32).contiguous()
    else:
        vr = v.to(torch.float32).contiguous()
        vi = torch.zeros_like(vr)
    outr, outi = cuda_fft.fft_inv(vr, vi)
    return torch.complex(outr, outi).movedim(-1, dim)


def _f32c(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous float32, itself where it is (no call made: a
    small transform's time is the host's)."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def fft_parts(re: torch.Tensor, im: torch.Tensor | None = None,
              bins: int | None = None, n: int | None = None, lo: int = 0):
    """``fft(re + i im)`` over the last axis (``im=None``: real input) as
    the two float32 parts of the spectrum, its first ``bins`` bins (None:
    all; real input only).  Real rows shorter than the transform stand at
    offset ``lo`` of ``n``-point rows of zeros (None: n is the rows'
    length).  The kernel tier writes the parts as they are, so a caller
    that takes a large spectrum apart never holds it as a complex tensor
    too (HPS's and PEF's 32768-point rows); from 8192 on it reads only the
    live samples and writes only the bins asked for (HPS's 4,096 samples
    of 32,768, its 10,001 bins)."""
    n = cuda_fft._check_span(re.shape[-1], n, lo, im)
    if not cuda_fft.supports(n):
        cuda_fft._check_bins(n, bins, im)
        z = cuda_fft._padded(re, n, lo)
        y = torch.fft.fft(z if im is None else torch.complex(z, im), dim=-1)
        return y.real[..., :bins], y.imag[..., :bins]
    return cuda_fft.fft_fwd(_f32c(re), None if im is None else _f32c(im),
                            bins, n, lo)


def ifft_parts(re: torch.Tensor, im: torch.Tensor, real_only: bool = False,
               n: int | None = None):
    """``ifft(re + i im)`` over the last axis, from the two float32 parts of
    the spectrum.  The kernel tier reads the parts as they are, so a caller
    that builds a large spectrum part by part never holds it as a complex
    tensor too (ST's inverse over every bin row).  ``real_only=True``
    returns the real part alone (the kernel then writes no imaginary
    part, and from 8192 on takes the real-row route).  With ``n`` given
    the parts are the n // 2 + 1 bins of a half spectrum and the result is
    ``irfft``'s real rows of n (PEF's cross-correlation, ``xcorr``: their
    products are Hermitian)."""
    if n is not None:
        if not cuda_fft.supports(n):
            return cuda_fft.fft_inv_ref(re, im, n=n)[0]
        return cuda_fft.fft_inv(re.to(torch.float32).contiguous(),
                                im.to(torch.float32).contiguous(), n=n)[0]
    m = re.shape[-1]
    if not cuda_fft.supports(m):
        y = torch.fft.ifft(torch.complex(re, im), dim=-1)
        return y.real if real_only else y
    outr, outi = cuda_fft.fft_inv(re.to(torch.float32).contiguous(),
                                  im.to(torch.float32).contiguous(),
                                  out_imag=not real_only)
    return outr if real_only else torch.complex(outr, outi)
