"""The FFT kernel's real-row route (``csrc/fft_pow2.cu`` ``real_fwd_kernel``
and ``real_inv_kernel``, n = 8192..32768) as a numpy float64 model of its
own indices, held against the JAX package's four-step kernels in Pallas
interpret mode (``fft4_fwd`` with real input, ``fft4_inv`` with
``out_imag=False``) at the kernels' 5e-5 of the peak; and the wrappers'
``bins`` on the CPU (the plain versions), with ``ops.fft.rfft`` and
``fft_parts(bins=)`` against ``jnp.fft``.

The model stands in for the kernel thread by thread: the pack z[m] =
x[2m] + i x[2m+1], the N-point transform (numpy's, N = n / 2), the split
of the pair (k, N - k) that thread k % T takes on its (k // T)-th round
(T = N / 16 threads), k = 0 with DC and Nyquist and k = N/2 paired with
itself, the stores of bins [0, bins) with the mirror half (NaN fill: each
bin written exactly once), and the inverse's four reads a pair (each
value of the row read exactly once) into the Hermitian part's halves."""

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
# twiddle table (each entry within 6e-8 of exact)
MODEL_TOL = 2e-7


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _tw(n):
    """The kernel's fp32 n-point table exp(-2 pi i k / n), as complex."""
    t = cuda_fft.twiddle_table(n, torch.device("cpu")).numpy()
    return t[:, 0].astype(np.float64) + 1j * t[:, 1]


def _rounds(N):
    """The ks of each round of the split loop: k = t + r T, t < T."""
    T = N // 16
    return [np.arange(T) + r * T for r in range(N // 2 // T)]


def _real_fwd_model(x, bins):
    """real_fwd_kernel on the rows of x (batch, n) -> (batch, bins)."""
    batch, n = x.shape
    N = n // 2
    tw = _tw(n)
    y = np.full((batch, bins), np.nan, dtype=complex)
    for row in range(batch):
        z = x[row, 0::2] + 1j * x[row, 1::2]      # the float2 view of the row
        Z = np.fft.fft(z)
        slot = np.full(N + 1, np.nan, dtype=complex)   # z[pad(k)], k <= N
        for ks in _rounds(N):
            k0 = ks[ks == 0]
            if k0.size:                  # thread 0: DC, Nyquist and N/2
                assert np.isnan(slot[[0, N, N // 2]]).all()
                slot[0] = Z[0].real + Z[0].imag
                slot[N] = Z[0].real - Z[0].imag
                slot[N // 2] = np.conj(Z[N // 2])
            k = ks[ks != 0]
            a, b = Z[k], Z[N - k]
            e = (a + np.conj(b)) / 2
            o = (a - np.conj(b)) / 2j
            wo = tw[k] * o
            assert np.isnan(slot[k]).all() and np.isnan(slot[N - k]).all()
            slot[k] = e + wo
            slot[N - k] = np.conj(e - wo)
        assert not np.isnan(slot).any()
        T = N // 16
        for t in range(T):
            k = np.arange(t, bins, T)
            v = np.where(k <= N, slot[np.minimum(k, N)],
                         np.conj(slot[np.minimum(n - k, N)]))
            assert np.isnan(y[row, k]).all(), "bin written twice"
            y[row, k] = v
    assert not np.isnan(y).any(), "bin never written"
    return y


def _real_inv_model(Y):
    """real_inv_kernel on the spectra Y (batch, n) -> Re(ifft(Y))."""
    batch, n = Y.shape
    N = n // 2
    tw = _tw(n)
    out = np.empty((batch, n))
    for row in range(batch):
        reads = np.zeros(n, dtype=int)

        def load(k):
            np.add.at(reads, k, 1)
            return Y[row, k]
        slot = np.full(N, np.nan, dtype=complex)   # conj Z at z[pad(k)]
        for ks in _rounds(N):
            if (ks == 0).any():
                a, b = 2 * load(0).real, 2 * load(N).real
                p, q = load(N // 2), load(N + N // 2)
                slot[0] = np.conj((a + b) + 1j * (a - b))
                slot[N // 2] = 2 * (p + np.conj(q))
            k = ks[ks != 0]
            A = load(k) + np.conj(load(n - k))
            B = load(N + k) + np.conj(load(N - k))
            e = A + B
            o = (A - B) * np.conj(tw[k])
            assert np.isnan(slot[k]).all() and np.isnan(slot[N - k]).all()
            slot[k] = np.conj(e + 1j * o)
            slot[N - k] = np.conj(np.conj(e) + 1j * np.conj(o))
        assert (reads == 1).all(), "a value read twice or never"
        F = np.fft.fft(slot)
        z = np.conj(F) * (0.5 / n)
        out[row, 0::2], out[row, 1::2] = z.real, z.imag
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
@pytest.mark.parametrize("kind", ["random", "hermitian"])
def test_real_inverse_model_and_round_trip(n, kind):
    """Re(ifft(Y)) of a random spectrum and of a real row's spectrum, and
    the round trip of the two models."""
    rng = np.random.default_rng(n + len(kind))
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
    n/2-point ones that the real-row route's transform reads (each within
    an fp32 rounding of every other entry of the first)."""
    n = 8192
    tab = cuda_fft._kernel_table(n, torch.device("cpu"))
    full = cuda_fft.twiddle_table(n, torch.device("cpu"))
    half = cuda_fft.twiddle_table(n // 2, torch.device("cpu"))
    assert tab.shape == (n + n // 2, 2)
    assert torch.equal(tab[:n], full) and torch.equal(tab[n:], half)
    assert float((half - full[::2]).abs().max()) <= 6e-8


def test_route_table():
    """Which route takes which call, and so which allocate the four-step
    buffer: complex rows at 32768 only."""
    got = {(n, real): cuda_fft.route(n, real)
           for n in (2048, 4096, 8192, 16384, 32768)
           for real in (False, True)}
    assert got == {(2048, False): "register", (2048, True): "register",
                   (4096, False): "register", (4096, True): "register",
                   (8192, False): "row", (8192, True): "real",
                   (16384, False): "row", (16384, True): "real",
                   (32768, False): "four_step", (32768, True): "real"}
    assert cuda_fft.REAL_MIN == 8192 and cuda_fft.FOUR_STEP_MIN == 32768


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
