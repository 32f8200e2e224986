"""Complex rows at n = 32768 (``csrc/fft_pow2.cu`` ``cluster_kernel``: one
cluster of two blocks a row) as a numpy float64 model of which block holds
which point, what crosses the pair, and each block's register transform
(the model of ``tests/test_torch_autocorr_regs.py``), and the port's plain
versions on the CPU against the JAX package's kernels in interpret mode.

Block `rank` stages half `rank` of the row, x[rank N + j] (N = n / 2);
thread t of either block reads its points j = j1 B + t (B = 256) of its
own half from its staging buffer and of the other half from the
partner's, through distributed shared memory: rank 0 forms a[j] = x[j] +
x[j + N], rank 1 b[j] = (x[j] - x[j + N]) W_n^j (the table's entry j),
each the input of the N-point register transform (the pass-1 factors of
N points, the table's first factor block), which leaves X[2k + rank] with
the thread that holds k.  The inverse conjugates the input's imaginary
part and the output's, with 1/n.  The autocorrelation squares each
block's bins in place (conjugated), runs the way back, which leaves E
(rank 0) and O (rank 1) at m = t + B m1, and crosses the pair once more:
rank 0 hands Im E[m] and rank 1 Im(W_n^m O[m]) to the other through its
transpose buffer; rank 0 writes -0.5 / n (Im E + Im W O) at m, rank 1 at
m + N the same with the sign of the second term turned."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops import pallas_fft as pfft
from audioflux_torch.ops import cuda_fft
from tests.test_torch_autocorr_regs import (_table, back, bins_of, factors,
                                            forward)

n = cuda_fft.CLUSTER_N
N = n // 2
B = N // 64
TOL = 5e-5          # the TPU kernel's contract, of the peak
MODEL_TOL = 1e-6    # the model (fp32 twiddles, float64 arithmetic)


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _rows(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class Pair:
    """The two blocks' shared memory: each stages its own half; reads of
    the partner's are counted, and every point of each half must be read
    by both blocks exactly once."""

    def __init__(self, x):
        self.stage = [x[:N].copy(), x[N:].copy()]
        self.reads = [np.zeros(N, int), np.zeros(N, int)]

    def load(self, rank):
        """Thread t's points j = j1 B + t: (own, partner's) values."""
        j = (np.arange(64)[:, None] * B + np.arange(B)).reshape(-1)
        self.reads[rank][j] += 1
        self.reads[rank ^ 1][j] += 1
        return j, self.stage[rank][j], self.stage[rank ^ 1][j]


def cluster_forward(x, sign=1.0):
    """Both blocks' transforms of x (conjugated where sign is -1): the
    spectrum X, each bin written once, by block (k % 2)."""
    tab = _table(n)
    fac = factors(n, N)
    assert np.array_equal(fac, tab[n:n + n // 8])
    pair = Pair(x)
    X = np.full(n, np.nan, dtype=complex)
    for rank in (0, 1):
        j, own, peer = pair.load(rank)
        own = own.real + 1j * sign * own.imag
        peer = peer.real + 1j * sign * peer.imag
        sg = -1.0 if rank else 1.0
        z = (peer + sg * own) * tab[j if rank else 0]
        zz = np.empty(N, dtype=complex)
        zz[j] = z
        v = forward(zz, fac)
        k2 = 2 * bins_of(N) + rank
        assert np.isnan(X[k2]).all(), "a bin written twice"
        X[k2] = v
    assert not np.isnan(X).any()
    assert all((r == 2).all() for r in pair.reads)
    return X, pair


def cluster_acf(xr, xi):
    """The autocorrelation through the pair: -0.5 / n Im(F), F = fft(conj
    S), S = fft(xr + i xi)^2."""
    tab = _table(n)
    fac = factors(n, N)
    pair = Pair(xr + 1j * xi)
    halves = []
    for rank in (0, 1):
        j, own, peer = pair.load(rank)
        sg = -1.0 if rank else 1.0
        zz = np.empty(N, dtype=complex)
        zz[j] = (peer + sg * own) * tab[j if rank else 0]
        v = forward(zz, fac)
        F = back(np.conj(v * v), fac)                 # [m1, t]
        m = np.arange(B) + B * np.arange(64)[:, None]
        h = (F * tab[m]).imag if rank else F.imag
        buf = np.full(N, np.nan)
        buf[m.reshape(-1)] = h.reshape(-1)            # the transpose buffer
        halves.append((m, h, buf))
    out = np.full(n, np.nan)
    for rank in (0, 1):
        m, h, _ = halves[rank]
        peer = halves[rank ^ 1][2][m]                 # ld_peer(buf + m)
        sg = -1.0 if rank else 1.0
        out[(rank * N + m).reshape(-1)] = (-0.5 / n * (sg * h + peer)
                                           ).reshape(-1)
    assert not np.isnan(out).any()
    return out


def test_forward_model_is_the_fft():
    """The pair's forward against float64, and every point of both halves
    read by each block once."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    X, _ = cluster_forward(x)
    assert _rel(X, np.fft.fft(x)) <= MODEL_TOL


def test_forward_model_matches_jax_kernel():
    """The pair's forward of a complex row against ``fft4_fwd`` in Pallas
    interpret mode (T-layout to natural) at 5e-5 of the peak."""
    xr, xi = _rows((2, n), 11)
    jr, ji = pfft.fft4_fwd(jnp.asarray(xr[None]), jnp.asarray(xi[None]),
                           interpret=True)
    ref = (np.asarray(pfft.t_to_natural(jr))
           + 1j * np.asarray(pfft.t_to_natural(ji)))[0]
    X, _ = cluster_forward(xr.astype(np.float64) + 1j * xi)
    assert _rel(X, ref) <= TOL


@pytest.mark.parametrize("real_spectrum", [False, True])
def test_inverse_model_matches_jax_kernel(real_spectrum):
    """The inverse (the forward of the conjugate, conjugated, 1/n) of a
    complex spectrum, and of one whose imaginary input is null (zeros),
    against ``fft4_inv`` in interpret mode and float64."""
    yr, yi = _rows((2, n), 12 + real_spectrum)
    if real_spectrum:
        yi = np.zeros_like(yi)
    Y = yr.astype(np.float64) + 1j * yi
    X, _ = cluster_forward(Y, sign=-1.0)
    got = np.conj(X) / n
    n1 = n // 128
    jr, ji = pfft.fft4_inv(pfft.natural_to_t(jnp.asarray(yr[None]), n1),
                           pfft.natural_to_t(jnp.asarray(yi[None]), n1),
                           interpret=True)
    ref = np.asarray(jr)[0] + 1j * np.asarray(ji)[0]
    assert _rel(got, ref) <= TOL
    assert _rel(got, np.fft.ifft(Y)) <= MODEL_TOL


def test_acf_model_matches_jax_kernel():
    """The pair's autocorrelation against ``fft4_autocorr`` in interpret
    mode at 5e-5 of the peak and against float64."""
    xr, xi = _rows((2, n), 13)
    jref = np.asarray(pfft.fft4_autocorr(jnp.asarray(xr[None]),
                                         jnp.asarray(xi[None]),
                                         interpret=True))[0]
    got = cluster_acf(xr.astype(np.float64), xi.astype(np.float64))
    Z = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    assert _rel(got, jref) <= TOL
    assert _rel(got, 0.5 * np.imag(np.fft.ifft(Z * Z))) <= MODEL_TOL


@pytest.mark.parametrize("out_imag", [True, False])
def test_plain_versions_match_jax_kernels(out_imag):
    """``fft_fwd``/``fft_inv`` on complex rows at 32768 (the plain versions
    on the CPU) against ``fft4_fwd``/``fft4_inv`` in interpret mode at 5e-5
    of the peak; they reach no kernel."""
    xr, xi = _rows((2, 3, n), 14 + out_imag)
    yr, yi = cuda_fft.fft_fwd(torch.from_numpy(xr), torch.from_numpy(xi))
    jr, ji = pfft.fft4_fwd(jnp.asarray(xr), jnp.asarray(xi), interpret=True)
    ref = (np.asarray(pfft.t_to_natural(jr))
           + 1j * np.asarray(pfft.t_to_natural(ji)))
    assert _rel(yr.numpy() + 1j * yi.numpy(), ref) <= TOL
    br, bi = cuda_fft.fft_inv(yr, yi, out_imag=out_imag)
    assert (bi is None) != out_imag
    n1 = n // 128
    jr, ji = pfft.fft4_inv(pfft.natural_to_t(jnp.asarray(yr.numpy()), n1),
                           pfft.natural_to_t(jnp.asarray(yi.numpy()), n1),
                           out_imag=out_imag, interpret=True)
    assert _rel(br.numpy(), np.asarray(jr)) <= TOL
    if out_imag:
        assert _rel(bi.numpy(), np.asarray(ji)) <= TOL
    assert cuda_fft.fft_fwd.cluster_launches == 0
    assert cuda_fft.fft_inv.cluster_launches == 0


def test_pair_crossings():
    """What crosses the pair: on the way in each block reads every point of
    the partner's half once (its own half once too); on the way out of the
    autocorrelation each block reads one float a point of the partner's
    buffer, every m < N once."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    _, pair = cluster_forward(x)
    assert [r.tolist() for r in pair.reads] == [[2] * N, [2] * N]
    m = np.arange(B) + B * np.arange(64)[:, None]
    assert sorted(m.reshape(-1).tolist()) == list(range(N))
