"""Batched FFTs for power-of-two n in [2048, 32768]: the CUDA kernels of
``csrc/fft_pow2.cu`` (forward, inverse, fused autocorrelation, YIN's
autocorrelation straight from the clips and the autocorrelation of
frames) and their plain PyTorch versions.

Counterpart of ``audioflux_tpu/ops/pallas_fft.py`` (``fft4_fwd``,
``fft4_inv``, ``fft4_autocorr``, ``supports``).  The kernels read and
write natural bin order, so the TPU package's layout converters
(``t_to_natural``, ``natural_to_t``, ``permute_bins_t``) have no
counterpart here.

Which route takes a call (:func:`route`):

* n = 2048, 4096 (:data:`REGISTER_N`): the register route, every
  direction and kind; it writes the full spectrum, so a forward's ``bins``
  is a copy of its first bins;
* n = 8192..32768, a forward of real rows or an inverse with real output
  (:data:`REAL_MIN`): the real-row route, one complex transform of n/2
  points a row in registers; a forward reads only the live span of its
  rows (``n`` and ``lo``: each row placed at ``lo`` in n zeros) and
  writes only its first ``bins`` natural-order bins, and an inverse takes
  a whole spectrum or the half that ``irfft`` takes (``n``);
* complex rows at 8192, 16384 (forward, or an inverse with an imaginary
  output): the row route, the real-row route's register transform on all
  n points, one row a block with the next row staged, the bins stored
  from registers in natural order;
* complex rows at 32768 (:data:`CLUSTER_N`), and ``fft_autocorr`` there:
  one launch of clusters of two blocks, a row a cluster, half the row in
  each block's registers, the halves joined through distributed shared
  memory; no device buffer.

``fft_autocorr`` at 8192 and 16384 runs the round trip in registers
(the real-row route's transform of n points, then the same passes in the
opposite order); :func:`fft_autocorr_frames` is its entry for frames
(NCF, HarmonicRatio), which forms both operands on the card and writes
only the lags asked for.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.observe import scope
from audioflux_torch.ops import _build
from audioflux_torch.ops.backend import require_sm90
from audioflux_torch.ops.frame import cal_time_length, frame_signal

__all__ = ["supports", "route", "fft_fwd", "fft_fwd_ref", "fft_inv",
           "fft_inv_ref", "fft_autocorr", "fft_autocorr_ref",
           "fft_autocorr_yin", "fft_autocorr_yin_ref", "fft_autocorr_frames",
           "fft_autocorr_frames_ref", "frame_operands", "twiddle_table"]

REGISTER_N = (2048, 4096)   # the lengths of the register-resident route
REAL_MIN = 8192             # from here on real rows take the real-row route
CLUSTER_N = 32768           # complex rows here take two-block clusters
FRAMES_N = (4096, 8192, 16384)  # the lengths of fft_autocorr_frames


def supports(n: int) -> bool:
    """The kernel's domain: pow2 n in [2048, 32768]."""
    return n > 0 and not n & (n - 1) and 2048 <= n <= 32768


def route(n: int, real: bool) -> str:
    """The route of a transform of n points: ``real`` is a forward of real
    rows or an inverse with real output.  "register", "real", "row" or
    "cluster" (complex rows at 32768)."""
    if n in REGISTER_N:
        return "register"
    if real:
        return "real"
    return "cluster" if n == CLUSTER_N else "row"


@functools.lru_cache(maxsize=None)
def twiddle_table(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) fp32 table exp(-2 pi i k / n), k < n, on ``device``; built in
    float64 on the host, so the kernels use no fast-math sine or cosine."""
    ang = -2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _pass1_factors(N: int) -> np.ndarray:
    """The register transform's pass-1 twiddles W_N^(t k1) of N points as
    two exact factors (``csrc/fft_real_reg.cuh``): W_N^(t r) at [r B + t],
    then W_N^(8 t q) at [8 B + q B + t], r, q < 8, t < B = N/64; (16 B, 2)
    fp32, built in float64."""
    t = np.arange(N // 64)
    e = np.concatenate([np.outer(np.arange(8), t),
                        np.outer(8 * np.arange(8), t)]).reshape(-1)
    ang = -2.0 * np.pi * e / N
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _kernel_table(n: int, device: torch.device) -> torch.Tensor:
    """The table the kernels take: :func:`twiddle_table` of n, then the
    pass-1 factors of n/2 points (the real-row route's and the clusters'),
    then those of n points (the autocorrelation in registers); n + n/8 +
    n/4 rows."""
    return torch.cat([twiddle_table(n, device),
                      torch.from_numpy(_pass1_factors(n // 2)).to(device),
                      torch.from_numpy(_pass1_factors(n)).to(device)])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fft_pow2")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd = [p, p, p, p, p, ll, i, i, i, i, i, p]
    inv = [p, p, p, p, p, ll, i, i, i, p]
    auto = [p, p, p, p, ll, i, p]
    yin = [p, p, p, ll, ll, i, i, i, i, p]
    frames = [p, p, p, ll, i, i, i, p]
    for fn, argtypes in ((lib.af_fft_pow2_fwd, fwd),
                         (lib.af_fft_pow2_inv, inv),
                         (lib.af_fft_pow2_autocorr, auto),
                         (lib.af_fft_pow2_autocorr_yin, yin),
                         (lib.af_fft_pow2_autocorr_frames, frames),
                         (lib.af_fft_pow2_resident_clusters, [i])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_rows(who: str, n=None, **tensors) -> int:
    """The checks every wrapper makes: pow2 n in the kernels' domain (the
    rows' length unless given), float32, contiguous, one shape and one
    device, a CPU or CUDA device.  Returns n.  (Written for few attribute
    reads: it runs on every call, and a small call's time is the host's.)"""
    first = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if first is None:
            first = t
        elif t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{' and '.join(tensors)} must share shape and "
                             "device")
    n = first.shape[-1] if n is None else int(n)
    if not supports(n):
        raise ValueError(f"{who} needs pow2 n in [2048, 32768], got {n}")
    if not (first.is_cuda or first.is_cpu):
        raise ValueError(f"unsupported device {first.device}")
    return n


_SM90_SEEN: set = set()   # the card indices require_sm90 has passed
_TABLE_PTRS: dict = {}    # (n, card index) -> the kernel table's address


def _call(fn, who: str, x: torch.Tensor, n: int, *ptrs, extra=()):
    """Launch ``fn(*ptrs, tw, batch, log2n, *extra, stream)`` on ``x``'s
    device and current stream, a row of ``x`` an item; raise on a CUDA
    error.  The per-call host work is kept to dictionary lookups: the
    card's check and the table are made once a card."""
    index = x.device.index
    if index not in _SM90_SEEN:
        require_sm90(x.device)
        _SM90_SEEN.add(index)
    tw = _TABLE_PTRS.get((n, index))
    if tw is None:
        tw = _TABLE_PTRS[(n, index)] = _kernel_table(n, x.device).data_ptr()
    args = (*ptrs, tw, x.numel() // x.shape[-1], n.bit_length() - 1, *extra)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{who} launch failed: CUDA error {err}")


def _check_bins(n: int, bins, xi) -> int:
    """``bins`` of a forward: None (all n), or 1..n with real input."""
    if bins is None:
        return n
    if xi is not None:
        raise ValueError("bins needs real input (xi=None)")
    if not 1 <= bins <= n:
        raise ValueError(f"bins must be in [1, {n}], got {bins}")
    return int(bins)


def _check_span(live: int, n, lo: int, xi) -> int:
    """The transform length of a forward whose rows are ``live`` samples
    placed at ``lo`` in ``n`` zeros (None: n = live).  Returns n."""
    n = live if n is None else int(n)
    if (n, lo) != (live, 0):
        if xi is not None:
            raise ValueError("n and lo need real input (xi=None)")
        if live < 1 or lo < 0 or lo + live > n:
            raise ValueError(f"rows of {live} at offset {lo} do not fit "
                             f"in n = {n}")
    return n


def _padded(x: torch.Tensor, n: int, lo: int) -> torch.Tensor:
    """Rows ``x`` placed at ``lo`` in rows of ``n`` zeros."""
    live = x.shape[-1]
    if (n, lo) == (live, 0):
        return x
    return F.pad(x, (lo, n - lo - live))


def fft_fwd_ref(xr: torch.Tensor, xi: torch.Tensor | None = None,
                bins: int | None = None, n: int | None = None, lo: int = 0):
    """Plain version: ``torch.fft.fft`` of ``xr + i xi`` (real rows
    placed at ``lo`` in ``n`` zeros) -> (re, im), its first ``bins`` bins
    (None: all)."""
    z = _padded(xr, xr.shape[-1] if n is None else n, lo)
    if xi is not None:
        z = torch.complex(z, xi)
    y = torch.fft.fft(z, dim=-1)[..., :bins]
    return y.real.contiguous(), y.imag.contiguous()


def fft_fwd(xr: torch.Tensor, xi: torch.Tensor | None = None,
            bins: int | None = None, n: int | None = None, lo: int = 0):
    """Forward FFT of (..., n) fp32 rows (``xi=None``: real input) ->
    (re, im), each (..., bins), natural bin order: the first ``bins`` bins
    of the spectrum (None: all n; 1 <= bins <= n, real input only).
    Real rows may be shorter than the transform: with ``n`` given, each
    row of ``live = xr.shape[-1]`` samples stands at offset ``lo`` of an
    n-point row of zeros (``lo + live <= n``), and the kernel reads only
    the live samples.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version.  ~1e-6 of the peak (the TPU kernel's contract
    is 5e-5).  At n = 2048 and 4096 real rows are transformed two at a time
    (one packed complex transform, separated in the kernel); from 8192 on
    each real row is one complex transform of n/2 points, and only the
    bins asked for are written."""
    with scope("af.kernel.fft_fwd"):
        n = _check_span(xr.shape[-1], n, lo, xi)
        _check_rows("fft_fwd", n, xr=xr, xi=xi)
        bins = _check_bins(n, bins, xi)
        if not xr.is_cuda:
            return fft_fwd_ref(xr, xi, bins, n, lo)
        return _fwd(xr, xi, n, bins, lo=lo)


def _fwd(xr, xi, n, bins=None, stages=3, lo=0):
    """Launch the forward kernel; ``stages`` 1 and 2 cut it, for
    measurements (the output is then not the spectrum): at n = 2048 and
    4096 after its first or second pass, on the real-row route after the
    load or after the n/2-point transform; on the row route (complex rows
    at 8192, 16384) 1 is the load and the store alone and 2 the whole
    spectrum with its stores through the transpose buffer."""
    bins = n if bins is None else bins
    live = xr.shape[-1]
    way = route(n, xi is None)
    if way != "real" and (n, lo) != (live, 0):   # the kernel reads whole rows
        xr = _padded(xr, n, lo).contiguous()
        live, lo = n, 0
    if way == "register" and bins < n:    # the route writes every bin
        yr, yi = _fwd(xr, xi, n, n, stages)
        return yr[..., :bins].contiguous(), yi[..., :bins].contiguous()
    shape = xr.shape[:-1] + (bins,)
    yr, yi = xr.new_empty(shape), xr.new_empty(shape)
    if xr.numel() == 0:
        return yr, yi
    _call(_lib().af_fft_pow2_fwd, "fft_pow2 forward", xr, n, xr.data_ptr(),
          None if xi is None else xi.data_ptr(), yr.data_ptr(),
          yi.data_ptr(), extra=(bins, lo, live, stages))
    _count(fft_fwd, way)
    fft_fwd.live_launches += int(live < n)
    return yr, yi


def _count(fn, way):
    fn.launches += 1
    setattr(fn, f"{way}_launches", getattr(fn, f"{way}_launches") + 1)


def _half_n(rows: int, n) -> int:
    """The length of a half spectrum's signal: ``rows == n // 2 + 1``."""
    if rows != int(n) // 2 + 1:
        raise ValueError(f"a half spectrum of n = {n} has {int(n) // 2 + 1} "
                         f"bins, got {rows}")
    return int(n)


def _hermitian(yr: torch.Tensor, yi: torch.Tensor, n: int):
    """The whole spectrum (re, im) of the half spectrum ``yr + i yi`` (n/2
    + 1 bins): bin n - k is conj Y[k], and the imaginary parts of bins 0
    and n/2 are dropped, as irfft drops them."""
    vi = yi.clone()
    vi[..., 0] = 0
    vi[..., n // 2] = 0
    return (torch.cat([yr, yr[..., 1:n // 2].flip(-1)], dim=-1),
            torch.cat([vi, -vi[..., 1:n // 2].flip(-1)], dim=-1))


def fft_inv_ref(yr: torch.Tensor, yi: torch.Tensor, out_imag: bool = True,
                n: int | None = None):
    """Plain version: ``torch.fft.ifft`` of ``yr + i yi`` -> (re, im or
    None); with ``n``, the real part of the inverse of the half spectrum's
    Hermitian extension -> (re, None) (the values ``ifft`` of the whole
    spectrum gives, to the last bit, where its upper half mirrors the
    lower)."""
    if n is not None:
        yr, yi = _hermitian(yr, yi, n)
        out_imag = False
    x = torch.fft.ifft(torch.complex(yr, yi), dim=-1)
    return x.real.contiguous(), (x.imag.contiguous() if out_imag else None)


def fft_inv(yr: torch.Tensor, yi: torch.Tensor, out_imag: bool = True,
            n: int | None = None):
    """Inverse FFT of a natural-order (..., n) fp32 spectrum pair -> (re,
    im), each (..., n), 1/n included: the exact inverse of :func:`fft_fwd`.
    ``out_imag=False`` returns ``(re, None)`` and writes no imaginary
    output (use when the result is known to be real).  With ``n`` given,
    the rows are the n/2 + 1 bins of a half spectrum, as ``irfft`` takes
    them (bin n - k is conj Y[k]; the imaginary parts of bins 0 and n/2
    are ignored), and the result is ``(re, None)``, real rows of n.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version.  From n = 8192 on, a real output takes the
    real-row route: Re(ifft(Y)) of any Y (the Hermitian part of Y is
    transformed), or of a half spectrum, one complex transform of n/2
    points a row."""
    with scope("af.kernel.fft_inv"):
        half = n is not None
        if half:
            n = _half_n(yr.shape[-1], n)
            out_imag = False
        n = _check_rows("fft_inv", n, yr=yr, yi=yi)
        if not yr.is_cuda:
            return fft_inv_ref(yr, yi, out_imag, n if half else None)
        way = route(n, not out_imag)
        if half and way != "real":     # the register route takes whole spectra
            yr, yi = _hermitian(yr, yi, n)
        xr = yr.new_empty(yr.shape[:-1] + (n,))
        xi = torch.empty_like(xr) if out_imag else None
        if yr.numel() == 0:
            return xr, xi
        _call(_lib().af_fft_pow2_inv, "fft_pow2 inverse", yr, n, yr.data_ptr(),
              yi.data_ptr(), xr.data_ptr(),
              None if xi is None else xi.data_ptr(),
              extra=(yr.shape[-1], 3))
        _count(fft_inv, way)
        fft_inv.half_launches += int(yr.shape[-1] < n)
        return xr, xi


def fft_autocorr_ref(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Plain version: ``0.5 * Im(ifft(fft(xr + i xi)^2))``."""
    z = torch.fft.fft(torch.complex(xr, xi), dim=-1)
    return (0.5 * torch.fft.ifft(z * z, dim=-1).imag).contiguous()


def fft_autocorr(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``0.5 * Im(ifft(fft(xr + i xi)^2))`` of two (..., n) fp32 rows: the
    circular convolution of ``xr`` with ``xi``, in one pass over the two
    operands: the whole round trip runs in registers (at 32768 in a
    cluster of two blocks a row), and the square never leaves the chip.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.fft_autocorr"):
        n = _check_rows("fft_autocorr", xr=xr, xi=xi)
        if not xr.is_cuda:
            return fft_autocorr_ref(xr, xi)
        out = torch.empty_like(xr)
        if xr.numel() == 0:
            return out
        _call(_lib().af_fft_pow2_autocorr, "fft_pow2 autocorrelation", xr, n,
              xr.data_ptr(), xi.data_ptr(), out.data_ptr())
        fft_autocorr.launches += 1
        fft_autocorr.cluster_launches += int(n == CLUSTER_N)
        return out


def resident_clusters(acf: bool = False) -> int:
    """The clusters of two blocks the current card holds at once for the
    complex rows at 32768 (``acf``: the autocorrelation's kernel), the grid
    of their persistent launch; raises on a CUDA error."""
    got = _lib().af_fft_pow2_resident_clusters(int(acf))
    if got < 0:
        raise RuntimeError(f"fft_pow2 cluster query failed: CUDA error "
                           f"{-got}")
    return got


def frame_operands(frames: torch.Tensor, n: int):
    """The two (..., n) operands whose :func:`fft_autocorr` is the
    autocorrelation of (..., L) frames, L <= n/2: the frames zero-padded to
    n, and ``rev[m] = frame[(-m) mod n]``."""
    L = frames.shape[-1]
    xr = F.pad(frames, (0, n - L)).contiguous()
    rev = torch.cat([frames[..., :1],
                     frames.new_zeros(frames.shape[:-1] + (n - L,)),
                     frames[..., 1:].flip(-1)], dim=-1).contiguous()
    return xr, rev


def fft_autocorr_frames_ref(frames: torch.Tensor, n: int,
                            lags: int) -> torch.Tensor:
    """Plain version of :func:`fft_autocorr_frames`: the two operands
    (:func:`frame_operands`), :func:`fft_autocorr_ref`, the first lags."""
    acf = fft_autocorr_ref(*frame_operands(frames, n))
    return acf[..., :lags].contiguous()


def fft_autocorr_frames(frames: torch.Tensor, n: int,
                        lags: int) -> torch.Tensor:
    """``real(ifft(|fft(frame, n)|^2))`` of (..., L) fp32 frames, L <= n/2,
    at lags 0 .. lags - 1: (..., lags).  It is :func:`fft_autocorr` of the
    frame and its reversal ``rev[m] = frame[(-m) mod n]``, which the kernel
    forms in registers from the frame's L samples (it reads only those,
    and writes only the lags asked for); the zero padding makes the
    circular correlation the linear one below lag n - L + 1.  ``n`` is
    4096, 8192 or 16384 (:data:`FRAMES_N`).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.fft_autocorr_frames"):
        L = frames.shape[-1]
        if n not in FRAMES_N:
            raise ValueError(f"fft_autocorr_frames needs n in {FRAMES_N}, "
                             f"got {n}")
        if not 1 <= L <= n // 2 or not 1 <= lags <= n:
            raise ValueError(f"need 1 <= L <= n/2 and 1 <= lags <= n, got L "
                             f"{L}, lags {lags}, n {n}")
        if frames.dtype != torch.float32:
            raise TypeError(f"frames must be float32, got {frames.dtype}")
        if frames.device.type == "cpu":
            return fft_autocorr_frames_ref(frames, n, lags)
        if frames.device.type != "cuda":
            raise ValueError(f"unsupported device {frames.device}")
        out = frames.new_empty(frames.shape[:-1] + (lags,))
        if out.numel() == 0:
            return out
        rows = frames.reshape(-1, L).contiguous()
        _call(_lib().af_fft_pow2_autocorr_frames, "fft_pow2 frames "
              "autocorrelation", rows, n, rows.data_ptr(), out.data_ptr(),
              extra=(L, lags))
        fft_autocorr_frames.launches += 1
        return out


def fft_autocorr_yin_ref(x: torch.Tensor, fft_length: int,
                         slide_length: int, auto_length: int) -> torch.Tensor:
    """Plain version of :func:`fft_autocorr_yin`: the frames, their
    reversed prefix padded to ``fft_length``, :func:`fft_autocorr_ref`, and
    the lags from ``auto_length`` on."""
    frames = frame_signal(x, fft_length, slide_length)
    rev = F.pad(frames[..., :auto_length + 1].flip(-1),
                (0, fft_length - auto_length - 1))
    acf = fft_autocorr_ref(frames.contiguous(), rev.contiguous())
    return acf[..., auto_length:].contiguous()


def fft_autocorr_yin(x: torch.Tensor, fft_length: int, slide_length: int,
                     auto_length: int) -> torch.Tensor:
    """YIN's autocorrelation of every frame of fp32 clips ``x`` (...,
    samples): frame t is ``x[..., t * slide_length:][:fft_length]`` (the
    frames that fit, no padding), ``z = frame + i rev`` with ``rev[j] =
    frame[auto_length - j]`` for ``j <= auto_length`` (else 0), and the
    result ``0.5 * Im(ifft(fft(z)^2))`` at lags ``auto_length ..
    fft_length - 1``: (..., T, fft_length - auto_length).  The kernel
    reads each frame straight from the clip and writes only the lags kept;
    ``fft_length`` is 2048 or 4096 (:data:`REGISTER_N`).

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version."""
    with scope("af.kernel.fft_autocorr_yin"):
        if fft_length not in REGISTER_N:
            raise ValueError(f"fft_autocorr_yin needs fft_length in "
                             f"{REGISTER_N}, got {fft_length}")
        if not 0 <= auto_length < fft_length or slide_length < 1:
            raise ValueError(f"need 0 <= auto_length < fft_length and "
                             f"slide_length >= 1, got {auto_length}, "
                             f"{slide_length}")
        if x.dtype != torch.float32:
            raise TypeError(f"x must be float32, got {x.dtype}")
        samples = x.shape[-1]
        frames = cal_time_length(samples, fft_length, slide_length)
        if frames <= 0:
            raise ValueError(f"signal too short to frame: n={samples} "
                             f"fft_length={fft_length}")
        if x.device.type == "cpu":
            return fft_autocorr_yin_ref(x, fft_length, slide_length,
                                        auto_length)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        require_sm90(x.device)
        lead = x.shape[:-1]
        out = torch.empty(lead + (frames, fft_length - auto_length),
                          dtype=torch.float32, device=x.device)
        if out.numel() == 0:
            return out
        x2 = x.reshape(-1, samples).contiguous()
        tw = twiddle_table(fft_length, x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().af_fft_pow2_autocorr_yin(
                x2.data_ptr(), out.data_ptr(), tw.data_ptr(), x2.shape[0],
                samples, frames, slide_length, auto_length,
                fft_length.bit_length() - 1, stream)
        if err:
            raise RuntimeError(f"fft_pow2 YIN autocorrelation launch failed: "
                               f"CUDA error {err}")
        fft_autocorr_yin.launches += 1
        return out


fft_fwd.launches = 0
fft_inv.launches = 0
fft_fwd.register_launches = 0   # those at n = 2048, 4096 (the register route)
fft_inv.register_launches = 0
fft_fwd.real_launches = 0       # real rows at n = 8192..32768 (real-row route)
fft_inv.real_launches = 0
fft_fwd.row_launches = 0        # complex rows at n = 8192, 16384 (row route)
fft_inv.row_launches = 0
fft_fwd.cluster_launches = 0    # complex rows at n = 32768 (cluster route)
fft_inv.cluster_launches = 0
fft_fwd.live_launches = 0       # real-row route, rows shorter than n
fft_inv.half_launches = 0       # real-row route, half spectra
fft_autocorr.launches = 0
fft_autocorr.cluster_launches = 0   # n = 32768
fft_autocorr_yin.launches = 0
fft_autocorr_frames.launches = 0
