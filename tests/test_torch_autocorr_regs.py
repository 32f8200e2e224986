"""The autocorrelation in registers at n = 8192 and 16384 (``csrc/
fft_pow2.cu`` ``acf_reg_kernel``, the round trip of ``csrc/fft_real_reg.cuh``
``real_route_transform`` and ``route_transform_back``) and its frames
entry (``cuda_fft.fft_autocorr_frames``, NCF's and HarmonicRatio's call),
as a numpy float64 model of the kernel's own indices, twiddles and pass
order, and the port's plain versions on the CPU against the JAX package.

The model follows the kernel thread by thread: N = n = 64 B points, B =
64 C threads (C = 2, 4; the frames entry also C = 1).  The forward is the
real-row route's transform of N points (pass 1 over j1 with the factor
product W_N^(t r) W_N^(8 t q) from the table's second factor block, the
transpose through rows of P = B + C floats, pass 2 with the literal
W_256^(jb ka 4 / C), the lanes' C-point DFT by the kernel's butterflies),
which leaves S[g + 64 ka + 4096 kb] with thread g C + jb at v[ka].  The
square, conjugated, stays there.  The way back: the lanes' C-point DFT
by decimation in time (lane 3 times -i before the second stage), the
same literals, the 64-point DFT over ka, the transpose written at
[g P + ma C + jb] and read at [k1 P + t], the same factor product on
slot bitrev(k1), the 64-point DFT over k1, which leaves F[t + B m1] with
thread t: out = -0.5 / n Im(F).  The 64-point DFTs are numpy's; what the
model checks is where each value goes and which twiddle it meets.  The
frames entry forms z[j] = f[j] + i f[(-j) mod n] (zero past the frame)
from the staged frame and keeps lags [0, lags)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.ops import pallas_fft as pfft
from audioflux_torch.mir.pitch import autocorr_operands, autocorr_rows
from audioflux_torch.ops import cuda_fft

TOL = 5e-5          # the TPU kernel's contract, of the peak
MODEL_TOL = 1e-6    # the model (fp32 twiddles, float64 arithmetic), of
                    # the peak
CPU = {"device": "cpu"}


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _f32(w):
    """Complex values rounded to fp32 parts, as complex128."""
    return (np.real(w).astype(np.float32).astype(np.float64)
            + 1j * np.imag(w).astype(np.float32))


def _table(n):
    """``cuda_fft._kernel_table(n)`` as complex: W_n^k (k < n), the pass-1
    factors of n/2 points, then those of n points."""
    t = cuda_fft._kernel_table(n, torch.device("cpu")).numpy()
    return t[:, 0].astype(np.float64) + 1j * t[:, 1]


def factors(n, N):
    """The pass-1 factor block of N points in the kernel table of n: N =
    n/2 at [n, n + n/8) (the real-row route, the clusters), N = n at
    [n + n/8, n + 3n/8) (the autocorrelation in registers)."""
    tab = _table(n)
    start = n if N == n // 2 else n + n // 8
    assert N in (n // 2, n)
    return tab[start:start + 16 * (N // 64)]


def _w256(m):
    return _f32(np.exp(-2j * np.pi * np.asarray(m) / 256))


def _bitrev(x, bits):
    return int(f"{x:0{bits}b}"[::-1], 2) if bits else 0


def _pass1(v, fac, B, slot):
    """Times W_N^(t k1) at row slot(k1) of v[., t]: the fp32 product of
    fac[r B + t] and fac[8 B + q B + t], k1 = 8 q + r (a factor alone
    where the other is 1)."""
    t = np.arange(B)
    out = v.copy()
    for k1 in range(1, 64):
        q, r = divmod(k1, 8)
        a, b = fac[r * B + t], fac[8 * B + q * B + t]
        w = b if r == 0 else a if q == 0 else _f32(a * b)
        out[slot(k1)] = v[slot(k1)] * w
    return out


def lanes(N):
    """(C, B, P, g, jb, kb) of the transform of N points."""
    C = N // 4096
    B = 64 * C
    t = np.arange(B)
    kb = np.array([_bitrev(j, C.bit_length() - 1) for j in t % C])
    return C, B, B + C, t // C, t % C, kb


def forward(z, fac):
    """real_route_transform of z (N points): v[ka, u] = Z[g + 64 ka +
    4096 kb] with thread u = g C + jb."""
    N = z.size
    C, B, P, g, jb, kb = lanes(N)
    t = np.arange(B)
    y1 = _pass1(np.fft.fft(z.reshape(64, B), axis=0), fac, B, lambda k: k)
    buf = np.full(64 * P, np.nan, dtype=complex)
    idx = (np.arange(64)[:, None] * P + t).reshape(-1)
    assert len(set(idx)) == idx.size
    buf[idx] = y1.reshape(-1)
    ja = np.arange(64)[:, None]
    u2 = buf[g * P + ja * C + jb]
    assert not np.isnan(u2).any()
    ka = np.arange(64)[:, None]
    v = np.fft.fft(u2, axis=0) * _w256(jb * ka * (4 // C))
    h = C // 2
    while h >= 1:
        p = v[:, t ^ h]
        x = np.where((jb & h) != 0, p - v, v + p)
        v = np.where((h == 2) & (jb == 3), -1j * x, x)
        h //= 2
    return v


def bins_of(N):
    """The bin of v[ka, u] after :func:`forward` (each bin once)."""
    C, B, P, g, jb, kb = lanes(N)
    k = g + 64 * np.arange(64)[:, None] + 4096 * kb
    assert len(set(k.reshape(-1))) == N
    return k


def back(v, fac):
    """route_transform_back: v[ka, u] = S[g + 64 ka + 4096 kb] -> F = DFT(S)
    with F[t + B m1] at [m1, t]."""
    N = v.size
    C, B, P, g, jb, kb = lanes(N)
    t = np.arange(B)
    h = 1
    while h <= C // 2:
        if h == 2:
            v = np.where(jb == 3, -1j * v, v)
        p = v[:, t ^ h]
        v = np.where((jb & h) != 0, p - v, v + p)
        h *= 2
    ka = np.arange(64)[:, None]
    w = np.fft.fft(v * _w256(jb * ka * (4 // C)), axis=0)     # [ma, u]
    buf = np.full(64 * P, np.nan, dtype=complex)
    idx = (g * P + np.arange(64)[:, None] * C + jb).reshape(-1)
    assert len(set(idx)) == idx.size, "a buffer word written twice"
    buf[idx] = w.reshape(-1)
    slot = np.array([_bitrev(k, 6) for k in range(64)])
    read = buf[np.arange(64)[:, None] * P + t]                # [k1, t]
    assert not np.isnan(read).any()
    r = np.empty_like(read)
    r[slot] = read                                   # v[bitrev(k1)]
    r = _pass1(r, fac, B, lambda k: slot[k])
    # the 64-point DFT of input in bit-reversed order: reg_dft
    return np.fft.fft(r[slot], axis=0)


def acf_model(xr, xi, fac, lags=None):
    """acf_reg_kernel on one row pair: -0.5 / n Im(F) at lags [0, lags)."""
    N = xr.size
    B = N // 64
    v = forward(xr + 1j * xi, fac)
    s = np.conj(v * v)
    F = back(s, fac)
    out = np.empty(N)
    out[(np.arange(B) + B * np.arange(64)[:, None]).reshape(-1)] = (
        -0.5 / N * F.imag).reshape(-1)
    return out[:lags]


def frames_model(f, n, lags):
    """The frames entry on one frame of L <= n/2 samples: z formed from the
    staged frame, the round trip, lags [0, lags)."""
    L = f.size
    j = np.arange(n)
    jr = (n - j) & (n - 1)
    xr = np.where(j < L, f[np.minimum(j, L - 1)], 0.0)
    xi = np.where(jr < L, f[np.minimum(jr, L - 1)], 0.0)
    return acf_model(xr, xi, factors(n, n), lags)


def _acf64(xr, xi):
    Z = np.fft.fft(xr + 1j * xi)
    return 0.5 * np.imag(np.fft.ifft(Z * Z))


def _rows(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_back_transform_model_is_the_fft(n):
    """The way back alone: from the forward's layout to natural order, the
    DFT of the bins (the forward's own sign), against float64."""
    rng = np.random.default_rng(n + 1)
    S = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    fac = factors(n, n)
    v = np.empty((64, n // 64), dtype=complex)
    v[...] = S[bins_of(n)]
    F = back(v, fac)
    got = np.empty(n, dtype=complex)
    B = n // 64
    got[(np.arange(B) + B * np.arange(64)[:, None]).reshape(-1)] = (
        F.reshape(-1))
    assert _rel(got, np.fft.fft(S)) <= MODEL_TOL


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_forward_model_is_the_fft(n):
    """The forward of n points with the table's second factor block."""
    rng = np.random.default_rng(n + 2)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v = forward(z, factors(n, n))
    got = np.empty(n, dtype=complex)
    got[bins_of(n).reshape(-1)] = v.reshape(-1)
    assert _rel(got, np.fft.fft(z)) <= MODEL_TOL


@pytest.mark.parametrize("n", [8192, 16384])
def test_acf_model_matches_jax_kernel(n):
    """The general entry's round trip against ``fft4_autocorr`` in Pallas
    interpret mode at the kernels' 5e-5 of the peak, and against float64
    at MODEL_TOL."""
    xr, xi = _rows((2, n), n)
    jref = np.asarray(pfft.fft4_autocorr(jnp.asarray(xr[None]),
                                         jnp.asarray(xi[None]),
                                         interpret=True))[0]
    got = acf_model(xr.astype(np.float64), xi.astype(np.float64),
                    factors(n, n))
    assert _rel(got, jref) <= TOL
    assert _rel(got, _acf64(xr.astype(np.float64),
                            xi.astype(np.float64))) <= MODEL_TOL


@pytest.mark.parametrize("n", [8192, 32768])
def test_plain_autocorr_matches_jax_kernel(n):
    """``fft_autocorr`` (the plain version on the CPU) at 8192 (the
    registers) and 32768 (the clusters) against ``fft4_autocorr`` in
    interpret mode at 5e-5 of the peak."""
    xr, xi = _rows((2, 2, n), n + 3)
    jref = np.asarray(pfft.fft4_autocorr(jnp.asarray(xr), jnp.asarray(xi),
                                         interpret=True))
    got = cuda_fft.fft_autocorr(torch.from_numpy(xr),
                                torch.from_numpy(xi)).numpy()
    assert _rel(got, jref) <= TOL
    assert cuda_fft.fft_autocorr.launches == 0


@pytest.mark.parametrize("n, L, lags", [(8192, 4096, 1001),
                                        (8192, 4096, 979),
                                        (8192, 4096, 1), (8192, 4096, 8192),
                                        (8192, 1000, 5000),
                                        (16384, 8192, 1001),
                                        (4096, 2048, 251), (8192, 4093, 17)])
def test_frames_model(n, L, lags):
    """The frames entry's model (operands formed from the frame, lags kept)
    against the linear autocorrelation in float64 at MODEL_TOL of the
    peak: NCF's and HarmonicRatio's lags, one lag, every lag, a short
    frame, 16384, 4096 and a length no multiple of 4."""
    f = _rows(L, n + L + lags).astype(np.float64)
    full = np.correlate(f, f, "full")[L - 1:]            # lags 0 .. L-1
    ref = np.zeros(n)
    ref[:L] = full
    ref[n - L + 1:] = full[1:][::-1]                     # the circular tail
    got = frames_model(f, n, lags)
    assert got.shape == (lags,)
    assert np.max(np.abs(got - ref[:lags])) <= MODEL_TOL * np.max(np.abs(ref))


@pytest.mark.parametrize("n, lags", [(4096, 4096), (8192, 1001),
                                     (8192, 8192), (16384, 979)])
def test_frames_plain_version(n, lags):
    """``fft_autocorr_frames`` on the CPU is ``fft_autocorr_ref`` of the
    operands NCF built before it, sliced, to the bit; and it reaches no
    kernel."""
    frames = torch.from_numpy(_rows((2, 3, n // 2), n))
    got = cuda_fft.fft_autocorr_frames(frames, n, lags)
    ref = cuda_fft.fft_autocorr_ref(*autocorr_operands(frames, n))
    assert got.shape == (2, 3, lags)
    assert torch.equal(got, ref[..., :lags])
    assert torch.equal(autocorr_rows(frames, n, lags), got)
    assert cuda_fft.fft_autocorr_frames.launches == 0


def test_frames_checks():
    """n outside 4096..16384, a frame longer than n/2, lags out of range and
    a dtype other than float32 raise."""
    x = torch.zeros(3, 4096)
    for args in ((x, 2048, 10), (x, 32768, 10), (torch.zeros(3, 4097),
                                                 8192, 10),
                 (x, 8192, 0), (x, 8192, 8193)):
        with pytest.raises(ValueError):
            cuda_fft.fft_autocorr_frames(*args)
    with pytest.raises(TypeError):
        cuda_fft.fft_autocorr_frames(x.double(), 8192, 10)


def _clip(seed, seconds=1.5, sr=32000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 196.0 * (1 + 0.01 * np.sin(2 * np.pi * 3 * t))
    tone = np.sin(2 * np.pi * np.cumsum(f0) / sr)
    return (0.5 * tone + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)


@pytest.mark.parametrize("r2e", [11, 12])
def test_ncf_matches_jax(r2e):
    """``PitchNCF.pitch`` (the frames entry's lags) against the JAX
    package's ``PitchNCF`` on a seeded clip, frame for frame."""
    x = _clip(r2e)
    kw = dict(samplate=32000, radix2_exp=r2e, slide_length=1024)
    got = aft.PitchNCF(**kw, **CPU).pitch(torch.from_numpy(x)).numpy()
    ref = np.asarray(af.PitchNCF(**kw).pitch(x))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("r2e", [11, 12])
def test_harmonic_ratio_matches_jax(r2e):
    """``HarmonicRatio.harmonic_ratio`` against the JAX package's on a
    seeded clip at 1e-4 (``chip_smoke.py``'s gate)."""
    x = _clip(r2e + 7)
    kw = dict(samplate=32000, radix2_exp=r2e, slide_length=512)
    got = aft.HarmonicRatio(**kw, **CPU).harmonic_ratio(
        torch.from_numpy(x)).numpy()
    ref = np.asarray(af.HarmonicRatio(**kw).harmonic_ratio(x))
    np.testing.assert_allclose(got, ref, atol=1e-4)
