"""The FFT kernel's real-row route (``csrc/fft_pow2.cu`` ``real_fwd_kernel``
and ``real_inv_kernel``, n = 8192..32768) as a numpy float64 model of its
own indices, held against the JAX package's four-step kernels in Pallas
interpret mode (``fft4_fwd`` with real input, ``fft4_inv`` with
``out_imag=False``) at the kernels' 5e-5 of the peak; and the wrappers'
``bins`` on the CPU (the plain versions), with ``ops.fft.rfft`` and
``fft_parts(bins=)`` against ``jnp.fft``.

The model stands in for the kernel thread by thread around its N-point
transform (numpy's here, N = n / 2; the register transform's own model is
``tests/test_torch_fft_real_regs.py``): the pack z[m] = x[2m] + i x[2m+1],
read from the live span alone; the split of the pair (k, N - k) that
thread k % T takes on its (k // T)-th round (T = N / 64 threads, 32
rounds; its twiddle W_n^k the table's W_n^(k % T) times the literal
W_128^(k // T)), k = 0 with DC, Nyquist and N/2; its four stores, bins k, n - k,
N - k and N + k (NaN fill: each bin written exactly once); and the
inverse's merge of point j (j = j1 T + t, thread t's j1-th point) from
Y[j], Y[n - j], Y[N + j], Y[N - j] of a whole spectrum (each value read
twice, by the points j and N - j) or Y[j], Y[N - j] of a half one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops import pallas_fft as pfft
from audioflux_torch.ops import cuda_fft
from audioflux_torch.ops import fft as tfft

REAL_N = (8192, 16384, 32768)
TOL = 5e-5          # the TPU kernel's contract, of the peak
# the model's own error against float64: it uses the kernel's fp32
# twiddles (a table entry times a literal, each within 2e-7 of exact)
MODEL_TOL = 2e-7


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _tw(n):
    """The kernel's fp32 n-point table exp(-2 pi i k / n), as complex."""
    t = cuda_fft.twiddle_table(n, torch.device("cpu")).numpy()
    return t[:, 0].astype(np.float64) + 1j * t[:, 1]


def _w128():
    """The kernel's literals W_128^q, q < 64, as fp32."""
    q = np.arange(64)
    return (np.cos(2 * np.pi * q / 128).astype(np.float32).astype(np.float64)
            - 1j * np.sin(2 * np.pi * q / 128).astype(np.float32))


def _split_tw(n, t, i):
    """The split's and the merge's twiddle W_n^(t + T i), T = n / 128: the
    table's exact W_n^t times the literal W_128^i, rounded to fp32."""
    w = _tw(n)[t] * _w128()[i]
    return w.real.astype(np.float32) + 1j * w.imag.astype(np.float32)


def _rounds(N):
    """The ks of each round of the split loop: k = t + r T, t < T."""
    T = N // 64
    return [np.arange(T) + r * T for r in range(N // 2 // T)]


def _pack(x, n, lo):
    """z[j] = x[2j] + i x[2j+1] of the row x placed at lo in n zeros, as
    the kernel reads it: only the samples in [lo, lo + len(x))."""
    p = np.arange(n)
    rel = p - lo
    live = (rel >= 0) & (rel < x.size)
    row = np.where(live, x[np.clip(rel, 0, x.size - 1)], 0.0)
    return row[0::2] + 1j * row[1::2]


def _real_fwd_model(x, bins, n=None, lo=0):
    """real_fwd_kernel on the rows of x (batch, live) -> (batch, bins)."""
    batch, live = x.shape
    n = live if n is None else n
    N = n // 2
    T = N // 64
    y = np.full((batch, bins), np.nan, dtype=complex)
    for row in range(batch):
        Z = np.fft.fft(_pack(x[row], n, lo))
        out = y[row]

        def put(b, v):
            ok = b < bins
            assert np.isnan(out[b[ok]]).all(), "bin written twice"
            out[b[ok]] = v[ok]
        for ks in _rounds(N):
            a = Z[ks]
            b = Z[np.where(ks == 0, N // 2, N - ks)]
            e = (a + np.conj(b)) / 2
            o = (a - np.conj(b)) / 2j
            wo = _split_tw(n, ks % T, ks // T) * o
            xa = np.where(ks == 0, a.real + a.imag, e + wo)
            xb = np.where(ks == 0, np.conj(b), np.conj(e - wo))
            z0 = ks == 0
            put(ks, xa)
            put(np.where(z0, N // 2, N - ks), xb)
            put(np.where(z0, n - N // 2, n - ks), np.conj(np.where(
                z0, xb, xa)))
            put(np.where(z0, N, N + ks), np.where(
                z0, a.real - a.imag, np.conj(xb)))
    assert not np.isnan(y).any(), "bin never written"
    return y


def _real_inv_model(Y, half=False):
    """real_inv_kernel on the spectra Y (batch, n), or on half spectra
    (batch, n/2 + 1) with ``half``, -> Re(ifft(Y)) (batch, n)."""
    batch, m = Y.shape
    n = 2 * (m - 1) if half else m
    N = n // 2
    T = N // 64
    out = np.empty((batch, n))
    for row in range(batch):
        reads = np.zeros(m, dtype=int)

        def load(k):
            np.add.at(reads, k, 1)
            return Y[row, k]
        z = np.empty(N, dtype=complex)
        for j1 in range(64):
            j = j1 * T + np.arange(T)           # thread t's j1-th point
            if half:
                A, B = load(j), np.conj(load(N - j))
                A[j == 0] = A[j == 0].real       # Y[0], Y[N]: real parts
                B[j == 0] = B[j == 0].real
            else:
                A = load(j) + np.conj(load((n - j) % n))
                B = load(N + j) + np.conj(load(N - j))
            e = A + B
            o = (A - B) * np.conj(_split_tw(n, j % T, j1))
            z[j] = np.conj(e + 1j * o)
        want = np.full(m, 2)
        if half:
            want[[0, N]] = 1
        assert (reads == want).all(), "a value read too often or too seldom"
        F = np.fft.fft(z)
        v = np.conj(F) * ((1.0 if half else 0.5) / n)
        out[row, 0::2], out[row, 1::2] = v.real, v.imag
    return out


def _rows(n, batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, n)).astype(
        np.float32)


@pytest.mark.parametrize("n", REAL_N)
def test_real_forward_model_matches_jax_kernel(n):
    """The model with every bin against fft4_fwd(real input) in interpret
    mode, T-layout brought to natural order."""
    x = _rows(n, 2, n)
    jr, ji = pfft.fft4_fwd(jnp.asarray(x), interpret=True)
    ref = (np.asarray(pfft.t_to_natural(jr))
           + 1j * np.asarray(pfft.t_to_natural(ji)))
    got = _real_fwd_model(x.astype(np.float64), n)
    assert _rel(got, ref) <= TOL
    assert _rel(got, np.fft.fft(x.astype(np.float64))) <= MODEL_TOL


@pytest.mark.parametrize("n", REAL_N)
def test_real_inverse_model_matches_jax_kernel(n):
    """The model on a spectrum that is not Hermitian against
    fft4_inv(out_imag=False) in interpret mode: both return the real part
    of the inverse."""
    rng = np.random.default_rng(n + 1)
    yr = rng.standard_normal((2, n)).astype(np.float32)
    yi = rng.standard_normal((2, n)).astype(np.float32)
    n1 = n // 128
    jr, ji = pfft.fft4_inv(pfft.natural_to_t(jnp.asarray(yr), n1),
                           pfft.natural_to_t(jnp.asarray(yi), n1),
                           out_imag=False, interpret=True)
    assert ji is None
    got = _real_inv_model(yr.astype(np.float64) + 1j * yi)
    assert _rel(got, np.asarray(jr)) <= TOL
    ref64 = np.fft.ifft(yr.astype(np.float64) + 1j * yi).real
    assert _rel(got, ref64) <= MODEL_TOL


@pytest.mark.parametrize("n", REAL_N)
@pytest.mark.parametrize("which", ["one", "half", "half+1", "half+2",
                                   "hps", "n-1", "n"])
def test_real_forward_model_bins(n, which):
    """Every bins count the stores distinguish: DC alone, up to Nyquist,
    one and two mirrored bins, HPS's 10,001 (past Nyquist at 16384; at 8192
    an odd count past Nyquist instead), all but one, all; against the
    float64 FFT."""
    hps = 10001 if n > 10001 else 3 * n // 4 + 1
    bins = {"one": 1, "half": n // 2, "half+1": n // 2 + 1,
            "half+2": n // 2 + 2, "hps": hps, "n-1": n - 1, "n": n}[which]
    x = _rows(n, 1, n + bins).astype(np.float64)
    got = _real_fwd_model(x, bins)
    assert got.shape == (1, bins)
    ref = np.fft.fft(x)[:, :bins]
    peak = np.max(np.abs(np.fft.fft(x)))
    assert np.max(np.abs(got - ref)) <= MODEL_TOL * peak


@pytest.mark.parametrize("n", REAL_N)
@pytest.mark.parametrize("kind", ["random", "hermitian", "half"])
def test_real_inverse_model_and_round_trip(n, kind):
    """Re(ifft(Y)) of a random spectrum and of a real row's spectrum, and
    the round trip of the two models; irfft of a random half spectrum
    (the imaginary parts of bins 0 and n/2 ignored)."""
    rng = np.random.default_rng(n + len(kind))
    if kind == "half":
        H = (rng.standard_normal((1, n // 2 + 1))
             + 1j * rng.standard_normal((1, n // 2 + 1)))
        got = _real_inv_model(H, half=True)
        ref = np.fft.irfft(H, n)
        assert np.max(np.abs(got - ref)) <= MODEL_TOL * np.abs(ref).max()
        return
    if kind == "random":
        Y = rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
    else:
        x = rng.standard_normal((1, n))
        Y = _real_fwd_model(x, n)
        assert _rel(Y, np.fft.fft(x)) <= MODEL_TOL
    got = _real_inv_model(Y)
    ref = np.fft.ifft(Y).real
    assert np.max(np.abs(got - ref)) <= MODEL_TOL * np.abs(ref).max()
    if kind == "hermitian":
        assert np.max(np.abs(got - x)) <= MODEL_TOL * np.abs(x).max()


@pytest.mark.parametrize("n", [2048] + list(REAL_N))
def test_fft_fwd_bins_plain(n):
    """``fft_fwd(x, bins=b)`` and ``fft_fwd_ref`` on the CPU: the first b
    bins of ``torch.fft.fft``, contiguous, over leading axes."""
    x = torch.from_numpy(_rows(n, 6, n + 7).reshape(2, 3, n))
    full = torch.fft.fft(x, dim=-1)
    for bins in (1, n // 2 + 1, min(10001, n), n):
        for fn in (cuda_fft.fft_fwd, cuda_fft.fft_fwd_ref):
            yr, yi = fn(x, None, bins)
            assert yr.shape == yi.shape == (2, 3, bins)
            assert yr.is_contiguous() and yi.is_contiguous()
            assert torch.equal(yr, full.real[..., :bins].contiguous())
            assert torch.equal(yi, full.imag[..., :bins].contiguous())
    assert cuda_fft.fft_fwd.launches == 0


def test_fft_fwd_bins_checks():
    """``bins`` with complex input, 0 or above n raises, as do the
    ``ops.fft.fft_parts`` calls that would pass it on."""
    x = torch.zeros(2, 8192)
    for args in ((x, x, 4097), (x, None, 0), (x, None, 8193),
                 (x, None, -1)):
        with pytest.raises(ValueError):
            cuda_fft.fft_fwd(*args)
    for re, im, bins in ((x, x, 10), (torch.zeros(2, 1000), None, 1001),
                         (torch.zeros(2, 1000), torch.zeros(2, 1000), 5)):
        with pytest.raises(ValueError):
            tfft.fft_parts(re, im, bins=bins)


def test_kernel_table():
    """The table the row kernels take: the n-point twiddles, then the
    pass-1 factors W_N^(t r) and W_N^(8 t q) of N = n/2 points (the
    real-row route's and the clusters'; t < N/64, r, q < 8), then those of
    N = n points (the autocorrelation in registers), each within an fp32
    rounding of the n-point entry of the same angle."""
    for n in REAL_N:
        tab = cuda_fft._kernel_table(n, torch.device("cpu"))
        full = cuda_fft.twiddle_table(n, torch.device("cpu"))
        B = n // 128
        assert tab.shape == (n + 16 * B + 32 * B, 2)
        assert torch.equal(tab[:n], full)
        r = torch.arange(8)[:, None]
        for start, b, step in ((n, B, 2), (n + 16 * B, 2 * B, 1)):
            t = torch.arange(b)
            assert float((tab[start:start + 8 * b]
                          - full[(step * r * t).reshape(-1)])
                         .abs().max()) <= 6e-8
            assert float((tab[start + 8 * b:start + 16 * b]
                          - full[(8 * step * r * t).reshape(-1)])
                         .abs().max()) <= 6e-8


def test_route_table():
    """Which route takes which call: complex rows at 32768 take the
    two-block clusters (no route allocates a device buffer)."""
    got = {(n, real): cuda_fft.route(n, real)
           for n in (2048, 4096, 8192, 16384, 32768)
           for real in (False, True)}
    assert got == {(2048, False): "register", (2048, True): "register",
                   (4096, False): "register", (4096, True): "register",
                   (8192, False): "row", (8192, True): "real",
                   (16384, False): "row", (16384, True): "real",
                   (32768, False): "cluster", (32768, True): "real"}
    assert cuda_fft.REAL_MIN == 8192 and cuda_fft.CLUSTER_N == 32768


@pytest.mark.parametrize("n", [4096] + list(REAL_N))
def test_rfft_and_fft_parts_bins_match_jnp(n):
    """``ops.fft.rfft`` (the real-row route's n//2+1 bins from 8192 on)
    along a non-last axis, and ``fft_parts(re, bins=)`` along the last,
    against ``jnp.fft``."""
    x = _rows(n, 3, n + 3)
    got = tfft.rfft(torch.from_numpy(x.T.copy()), dim=0).numpy()
    assert got.shape == (n // 2 + 1, 3)
    assert _rel(got, np.asarray(jnp.fft.rfft(x.T, axis=0))) <= 1e-5
    bins = min(10001, n)
    yr, yi = tfft.fft_parts(torch.from_numpy(x), bins=bins)
    ref = np.asarray(jnp.fft.fft(x))[:, :bins]
    assert yr.shape == (3, bins)
    assert _rel(yr.numpy() + 1j * yi.numpy(), ref) <= 1e-5
    yr, yi = tfft.fft_parts(torch.from_numpy(x[:, :1000]), bins=17)
    assert _rel(yr.numpy() + 1j * yi.numpy(),
                np.asarray(jnp.fft.fft(x[:, :1000]))[:, :17]) <= 1e-5
