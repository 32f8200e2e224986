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
        return torch.fft.rfft(x, n=n, dim=dim)
    v = _prep(x, ln, dim).to(torch.float32).contiguous()
    m = ln // 2 + 1
    if ln >= cuda_fft.REAL_MIN:     # the real-row route writes m bins only
        yr, yi = cuda_fft.fft_fwd(v, bins=m)
    else:                           # the register route writes all of them
        yr, yi = cuda_fft.fft_fwd(v)
        yr, yi = yr[..., :m], yi[..., :m]
    return torch.complex(yr, yi).movedim(-1, dim)


def fft(x: torch.Tensor, n=None, dim=-1, exact=False) -> torch.Tensor:
    ln = n if n is not None else x.shape[dim]
    if not _kernel_tier(ln, exact):
        return torch.fft.fft(x, n=n, dim=dim)
    v = _prep(x, ln, dim)
    if v.is_complex():
        yr, yi = cuda_fft.fft_fwd(v.real.to(torch.float32).contiguous(),
                                  v.imag.to(torch.float32).contiguous())
    else:
        yr, yi = cuda_fft.fft_fwd(v.to(torch.float32).contiguous())
    return torch.complex(yr, yi).movedim(-1, dim)


def irfft(x: torch.Tensor, n=None, dim=-1, exact=False) -> torch.Tensor:
    ln = n if n is not None else 2 * (x.shape[dim] - 1)
    if not _kernel_tier(ln, exact):
        return torch.fft.irfft(x, n=n, dim=dim)
    v = _prep(x, ln // 2 + 1, dim)
    # hermitian extension, then the inverse kernel; the imaginary parts of
    # the DC and Nyquist bins are dropped, torch.fft.irfft's convention on
    # hermitian-inconsistent input
    if v.is_complex():
        vr = v.real.to(torch.float32)
        vi = v.imag.to(torch.float32).clone()
        vi[..., 0] = 0
        vi[..., -1] = 0
    else:
        vr = v.to(torch.float32)
        vi = torch.zeros_like(vr)
    yr = torch.cat([vr, vr[..., 1:ln // 2].flip(-1)], dim=-1)
    yi = torch.cat([vi, -vi[..., 1:ln // 2].flip(-1)], dim=-1)
    out, _ = cuda_fft.fft_inv(yr, yi, out_imag=False)
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


def fft_parts(re: torch.Tensor, im: torch.Tensor | None = None,
              bins: int | None = None):
    """``fft(re + i im)`` over the last axis (``im=None``: real input) as
    the two float32 parts of the spectrum, its first ``bins`` bins (None:
    all; real input only).  The kernel tier writes the parts as they are,
    so a caller that takes a large spectrum apart never holds it as a
    complex tensor too (HPS's and PEF's 32768-point rows), and from 8192
    on it writes only the bins asked for (HPS's 10,001 of 32,768)."""
    n = re.shape[-1]
    if not cuda_fft.supports(n):
        cuda_fft._check_bins(n, bins, im)
        y = torch.fft.fft(re if im is None else torch.complex(re, im), dim=-1)
        return y.real[..., :bins], y.imag[..., :bins]
    return cuda_fft.fft_fwd(
        re.to(torch.float32).contiguous(),
        None if im is None else im.to(torch.float32).contiguous(), bins)


def ifft_parts(re: torch.Tensor, im: torch.Tensor, real_only: bool = False):
    """``ifft(re + i im)`` over the last axis, from the two float32 parts of
    the spectrum.  The kernel tier reads the parts as they are, so a caller
    that builds a large spectrum part by part never holds it as a complex
    tensor too (ST's inverse over every bin row).  ``real_only=True``
    returns the real part alone (the kernel then writes no imaginary
    part, and from 8192 on takes the real-row route: PEF's
    cross-correlation, ``xcorr``)."""
    n = re.shape[-1]
    if not cuda_fft.supports(n):
        y = torch.fft.ifft(torch.complex(re, im), dim=-1)
        return y.real if real_only else y
    outr, outi = cuda_fft.fft_inv(re.to(torch.float32).contiguous(),
                                  im.to(torch.float32).contiguous(),
                                  out_imag=not real_only)
    return outr if real_only else torch.complex(outr, outi)
