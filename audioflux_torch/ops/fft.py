"""FFT entry points with a kernel tier for mid-size transforms.

Counterpart of ``audioflux_tpu/ops/fft.py``.  Two tiers:

* pow2 2048 <= n <= 32768: ``ops.cuda_fft.fft_fwd`` — the hand-written
  CUDA kernel for a CUDA tensor, its plain version for a CPU tensor;
* everything else (and every inverse transform): ``torch.fft``.

``exact=True`` skips the kernel tier: log-magnitude cepstral consumers
amplify a kernel's small error on near-zero bins through log() into argmax
flips, so they pin ``torch.fft``.  (The TPU package's dense-DFT tier for
n < 2048 worked around that backend's FFT and has no counterpart.)
"""

from __future__ import annotations

import torch

from audioflux_torch.ops import cuda_fft

__all__ = ["rfft", "irfft", "fft", "ifft"]


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
    yr, yi = cuda_fft.fft_fwd(v)
    m = ln // 2 + 1
    return torch.complex(yr[..., :m], yi[..., :m]).movedim(-1, dim)


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
    """Inverse real FFT (``torch.fft``; the inverse kernel is not ported)."""
    return torch.fft.irfft(x, n=n, dim=dim)


def ifft(x: torch.Tensor, n=None, dim=-1, exact=False) -> torch.Tensor:
    """Inverse FFT (``torch.fft``; the inverse kernel is not ported)."""
    return torch.fft.ifft(x, n=n, dim=dim)
