"""The CWT/PWT filterbank convolution ``ifft(bank * F)[pad : pad + L]``:
the CUDA kernel ``csrc/cwt_ifft_bank.cu`` and its plain PyTorch version.

Counterpart of ``audioflux_tpu/ops/pallas_cwt.py`` (``cwt_ifft_bank``,
``supports``, ``band_row_counts``).  The kernel's domain is every power of
two N in [2^14, 2^17] with any ``pad + length <= N``: the TPU kernel's
further gate (its row count R dividing ``pad`` and ``length``) served that
kernel's block shapes and is not kept.  ``band_row_counts`` is the TPU
package's, value for value: with n1 = 2^ceil(log2 N / 2) it counts the
leading rows of the (n1, N / n1) view of each band that hold a nonzero, and
the kernel reads only those (skipping them drops exact zeros, so the
result is the same).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audioflux_torch.ops import _build
from audioflux_torch.ops.backend import require_sm90
from audioflux_torch.ops.cuda_fft import twiddle_table

__all__ = ["supports", "band_row_counts", "cwt_ifft_bank",
           "cwt_ifft_bank_ref"]

# band-rows per pair of launches: their scratch (chunk * N * 8 bytes) is
# reused by the next pair and kept to this many bytes.  On the H100 large
# chunks measured faster than chunks whose scratch stays in the L2 cache
# (chip_smoke.py phase 4c prints the sweep).
_SCRATCH_BYTES = 1 << 30


def supports(n: int, pad: int, length: int) -> bool:
    """The kernel's domain: pow2 N in [2^14, 2^17], pad + length <= N."""
    return (n > 0 and not n & (n - 1) and (1 << 14) <= n <= (1 << 17)
            and pad >= 0 and length > 0 and pad + length <= n)


def band_row_counts(bank, n: int):
    """Per band, the number of leading rows (a multiple of 8) of the
    (R, n / R) row-major view, R = 2^ceil(log2 n / 2), that cover every
    nonzero of the (num, n) float32 bank.  A band whose support is not a
    leading run gets all R rows."""
    bank = np.asarray(bank)
    e = n.bit_length() - 1
    R = 1 << ((e + 1) // 2)
    C = n // R
    nz = (bank.reshape(bank.shape[0], R, C) != 0).any(axis=2)   # (num, R)
    last = R - 1 - np.argmax(nz[:, ::-1], axis=1)                # last nonzero row
    rows = np.where(nz.any(axis=1), last + 1, 1)
    return tuple(int(v) for v in np.minimum(-(-rows // 8) * 8, R))


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("cwt_ifft_bank").af_cwt_ifft_bank
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, i, ll, p]
    fn.restype = ctypes.c_int
    return fn


def cwt_ifft_bank_ref(F: torch.Tensor, bank: torch.Tensor, *, pad: int,
                      length: int, det: bool = False) -> torch.Tensor:
    """Plain version: ``torch.fft.ifft(bank * F[:, None, :])[..., pad : pad
    + length]``, times ``1j`` when ``det``."""
    out = torch.fft.ifft(bank * F[:, None, :], dim=-1)[..., pad:pad + length]
    if det:
        out = out * 1j
    return out.contiguous()


def cwt_ifft_bank(F: torch.Tensor, bank: torch.Tensor, *, pad: int,
                  length: int, det: bool = False, row_h=None,
                  chunk: int | None = None) -> torch.Tensor:
    """(B, N) complex64 spectrum x (num, N) float32 bank -> (B, num,
    length) complex64: per band ``ifft(bank * F)[pad : pad + length]``
    (times ``i`` when ``det``), fp32 throughout, ~1e-6 of the peak.

    ``row_h``: ``None`` or a (num,) int32 tensor on ``F``'s device, from
    :func:`band_row_counts`.  ``chunk``: band-rows per pair of launches
    (default: what keeps the scratch buffer at 1 GiB).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    if F.dim() != 2 or bank.dim() != 2 or F.shape[1] != bank.shape[1]:
        raise ValueError(f"F must be (B, N) and bank (num, N), got "
                         f"{tuple(F.shape)} and {tuple(bank.shape)}")
    if F.dtype != torch.complex64 or bank.dtype != torch.float32:
        raise TypeError(f"F must be complex64 and bank float32, got "
                        f"{F.dtype} and {bank.dtype}")
    if bank.device != F.device:
        raise ValueError("F and bank must lie on one device")
    n = F.shape[1]
    if not supports(n, pad, length):
        raise ValueError(f"cwt_ifft_bank needs pow2 N in [2^14, 2^17] and "
                         f"pad + length <= N, got N={n}, pad={pad}, "
                         f"length={length}")
    if F.device.type == "cpu":
        return cwt_ifft_bank_ref(F, bank, pad=pad, length=length, det=det)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    if not F.is_contiguous() or not bank.is_contiguous():
        raise ValueError("F and bank must be contiguous")
    num = bank.shape[0]
    if row_h is not None and (
            row_h.dtype != torch.int32 or row_h.shape != (num,)
            or row_h.device != F.device or not row_h.is_contiguous()):
        raise ValueError("row_h must be a contiguous (num,) int32 tensor on "
                         "F's device")
    require_sm90(F.device)
    B = F.shape[0]
    out = torch.empty((B, num, length), dtype=torch.complex64,
                      device=F.device)
    if out.numel() == 0:
        return out
    if chunk is None:
        chunk = max(1, _SCRATCH_BYTES // (8 * n))
    chunk = min(int(chunk), B * num)
    if chunk < 1:
        raise ValueError("chunk must be positive")
    scratch = torch.empty((chunk, n, 2), dtype=torch.float32, device=F.device)
    tw = twiddle_table(n, F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = _lib()(F.data_ptr(), bank.data_ptr(),
                     None if row_h is None else row_h.data_ptr(),
                     out.data_ptr(), scratch.data_ptr(), tw.data_ptr(), B,
                     num, n.bit_length() - 1, pad, length, int(bool(det)),
                     chunk, stream)
    if err:
        raise RuntimeError(f"cwt_ifft_bank launch failed: CUDA error {err}")
    cwt_ifft_bank.launches += 1
    return out


cwt_ifft_bank.launches = 0
