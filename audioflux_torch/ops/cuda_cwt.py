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

The kernel is one launch of thread block clusters (sm_90): the blocks of a
cluster hold one band-row's N points in their shared memory together and
exchange them there, so there is no device scratch.  :func:`cluster_plan`
picks the cluster size for N; a card that cannot hold one such cluster
makes the wrapper raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audioflux_torch.observe import scope, setup_table
from audioflux_torch.ops import _build
from audioflux_torch.ops.cuda_fft import twiddle_table

__all__ = ["supports", "band_row_counts", "cluster_plan",
           "resident_clusters", "cwt_ifft_bank", "cwt_ifft_bank_ref"]

_SMEM_MAX = 232448      # bytes of shared memory a block may have on sm_90
_MAX_CLUSTER = 8        # the portable cluster size
_POINTS = 16            # points a thread holds (csrc/fft_smem.cuh)


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


def cluster_plan(n: int, cluster: int | None = None) -> dict:
    """The launch shape of the kernel for pow2 ``n`` in [2^14, 2^17].

    ``cluster`` blocks share a band-row: block c owns ``ncol = n2 /
    cluster`` columns of the (n1, n2) view in the first pass and ``nrow =
    n1 / cluster`` rows in the second, ``points = n / cluster`` of them
    either way, 16 a thread.  The default is the cluster that gives a
    block 8192 points (512 threads and under half an SM's shared memory,
    so that two blocks share an SM), capped at the portable size 8; a
    given ``cluster`` must leave a block 8192 or 16384 points.  ``smem`` is
    the block's shared memory in bytes: the points, padded, and the
    twiddle tables."""
    if n <= 0 or n & (n - 1) or not (1 << 14) <= n <= (1 << 17):
        raise ValueError(f"cluster_plan needs pow2 n in [2^14, 2^17], got {n}")
    e = n.bit_length() - 1
    n1 = 1 << ((e + 1) // 2)
    n2 = n // n1
    if cluster is None:
        cluster = min(_MAX_CLUSTER, n // 8192)
    points = n // cluster if cluster > 0 and not cluster & (cluster - 1) else 0
    if cluster > _MAX_CLUSTER or points not in (8192, 16384):
        raise ValueError(f"n={n} does not split over a cluster of {cluster}")
    ncol, nrow = n2 // cluster, n1 // cluster

    def stride(length):     # row_stride of the source
        return length + length // 16 + 1

    def table(length):      # pass_table_len of the source
        total, ns = 0, 16
        while ns < length:
            radix = min(16, length // ns)
            total += radix * ns
            ns *= radix
        return total
    smem = 8 * (max(ncol * stride(n1), nrow * stride(n2)) + _POINTS * nrow
                + table(n1) + table(n2))
    if smem > _SMEM_MAX:
        raise ValueError(f"n={n}, cluster={cluster}: {smem} bytes of shared "
                         "memory do not fit a block")
    return dict(cluster=cluster, n1=n1, n2=n2, ncol=ncol, nrow=nrow,
                points=points, threads=points // _POINTS, smem=smem,
                blocks_per_sm=2 if points == 8192 else 1)


@functools.lru_cache(maxsize=None)
@setup_table
def _lib():
    lib = _build.load("cwt_ifft_bank")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.af_cwt_ifft_bank.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i, i,
                                     p]
    lib.af_cwt_ifft_bank.restype = ctypes.c_int
    lib.af_cwt_max_clusters.argtypes = [i, i]
    lib.af_cwt_max_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
@setup_table
def resident_clusters(n: int, cluster: int, device_index: int) -> int:
    """How many clusters of ``cluster`` blocks the card holds at once for
    transform length ``n``: the size of the kernel's persistent grid.
    Raises when the card cannot hold one."""
    with torch.cuda.device(device_index):
        got = _lib().af_cwt_max_clusters(
            n.bit_length() - 1, cluster.bit_length() - 1)
    if got < 0:
        raise RuntimeError(f"cwt_ifft_bank: the cluster occupancy query "
                           f"failed: CUDA error {-got}")
    if got == 0:
        plan = cluster_plan(n, cluster)
        raise RuntimeError(
            f"cwt_ifft_bank: this card cannot hold one cluster of {cluster} "
            f"blocks of {plan['threads']} threads and {plan['smem']} bytes "
            f"of shared memory (N={n}); the kernel needs thread block "
            "clusters with that much shared memory a block (sm_90)")
    return got


def cwt_ifft_bank_ref(F: torch.Tensor, bank: torch.Tensor, *, pad: int,
                      length: int, det: bool = False) -> torch.Tensor:
    """Plain version: ``torch.fft.ifft(bank * F[:, None, :])[..., pad : pad
    + length]``, times ``1j`` when ``det``."""
    out = torch.fft.ifft(bank * F[:, None, :], dim=-1)[..., pad:pad + length]
    if det:
        out = out * 1j
    return out.contiguous()


def cwt_ifft_bank(F: torch.Tensor, bank: torch.Tensor, *, pad: int,
                  length: int, det: bool = False,
                  row_h=None) -> torch.Tensor:
    """(B, N) complex64 spectrum x (num, N) float32 bank -> (B, num,
    length) complex64: per band ``ifft(bank * F)[pad : pad + length]``
    (times ``i`` when ``det``), fp32 throughout, ~1e-6 of the peak.

    ``row_h``: ``None`` or a (num,) int32 tensor on ``F``'s device, from
    :func:`band_row_counts`.

    A CUDA tensor launches the kernel (one cluster launch, sm_90 only) or
    raises; a CPU tensor takes the plain version."""
    with scope("af.kernel.cwt_ifft_bank"):
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
            raise ValueError("row_h must be a contiguous (num,) int32 "
                             "tensor on F's device")
        out = torch.empty((F.shape[0], num, length), dtype=torch.complex64,
                          device=F.device)
        return _launch(F, bank, row_h, out, pad, length, det)


def _launch(F, bank, row_h, out, pad, length, det, cluster=None,
            n_clusters=None, stages=4):
    """Run the kernel into ``out`` (a (B, num, length) complex64 tensor or
    view whose rows are contiguous).  ``cluster`` and ``n_clusters``
    default to :func:`cluster_plan`'s size and the resident count; other
    values are for measurements, as is ``stages`` (1 to 3 cut the kernel
    after its load, its first pass or its exchange; ``out`` is then not
    the transform)."""
    n = F.shape[1]
    if (out.dtype != torch.complex64 or out.device != F.device
            or tuple(out.shape) != (F.shape[0], bank.shape[0], length)
            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (B, num, length) "
                         "complex64 tensor on F's device")
    if out.numel() == 0:
        return out
    cluster = cluster_plan(n, cluster)["cluster"]
    index = F.device.index
    if index is None:
        index = torch.cuda.current_device()
    if n_clusters is None:
        n_clusters = resident_clusters(n, cluster, index)
    _build.launch(
        _lib().af_cwt_ifft_bank, "cwt_ifft_bank", F.device, F.data_ptr(),
        bank.data_ptr(), None if row_h is None else row_h.data_ptr(),
        out.data_ptr(), twiddle_table(n, F.device).data_ptr(), F.shape[0],
        bank.shape[0], n.bit_length() - 1, pad, length, int(bool(det)),
        cluster.bit_length() - 1, int(n_clusters), stages)
    cwt_ifft_bank.launches += 1
    return out


cwt_ifft_bank.launches = 0
