"""The real-row route's register transform (``csrc/fft_real_reg.cuh``,
``real_fwd_kernel``/``real_inv_kernel`` in ``csrc/fft_pow2.cu``) as a numpy
float64 model of its own indices and twiddles, and the port's live-span and
half-spectrum entries on the CPU, against the JAX package.

The model follows the kernel thread by thread: N = n / 2 = 64 B points, B
= 64 C threads.  Pass 1: thread t's 64-point DFT of column t, times
W_N^(t k1) as the fp32 product of the table's W_N^(t r) and W_N^(8 t q)
(k1 = 8 q + r); the transpose through a buffer of 64 rows of P = B + C
(written at [k1 P + t], read at [g P + ja C + jb] by thread g C + jb);
pass 2: the 64-point DFT over ja, times the fp32 literal W_256^(jb ka 4 /
C); pass 3: the C-point DFT over the lanes jb by the kernel's butterflies
(the upper lane of a pair takes p - v, the lower v + p, lane 3's first
stage times -i), which leaves Z[g + 64 ka + 4096 bitrev(jb)] with lane jb
(each bin once).  The forward's pair buffer (complex, skewed 16 / C words
a 4096), the split with the twiddle W_n^t W_128^i, the stores of bins k, N
- k, n - k and N + k (each bin once); the inverse's merge of point j from
a whole or a half spectrum.  The 64-point DFTs themselves are numpy's:
what the model checks is where each value goes and which twiddle it meets.

Against ``fft4_fwd``/``fft4_inv`` in Pallas interpret mode at the kernels'
5e-5 of the peak, and against a float64 FFT at REGS_TOL, derived below."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.ops import pallas_fft as pfft
from audioflux_torch.ops import cuda_fft
from audioflux_torch.ops import fft as tfft

REAL_N = (8192, 16384, 32768)
TOL = 5e-5          # the TPU kernel's contract, of the peak
# The model's error against float64 comes from its fp32 twiddles alone.
# With u = 2^-24, an fp32 table entry or literal is within sqrt(2) u / 2 of
# exact, and a product of two of them, rounded, within 3 sqrt(2) u / 2 =
# 1.27e-7.  A forward row meets three: pass 1's product (1.27e-7), pass 2's
# literal (0.43e-7) and the split's product (1.27e-7); each perturbs its
# stage's values by at most that share of their size, and the later stages
# are unitary up to scale, so the error they leave is at most their sum,
# 2.97e-7, of the values' size, spread over the bins.  A random row's peak
# bin is a few times its rms, so the error over the peak stays below
# that sum; REGS_TOL keeps the sum, rounded up.  (The inverse meets the
# merge's product instead of the split's: the same sum.)
REGS_TOL = 3e-7
CPU = {"device": "cpu"}


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _f32(w):
    """Complex values rounded to fp32 parts, as complex128."""
    return (np.real(w).astype(np.float32).astype(np.float64)
            + 1j * np.imag(w).astype(np.float32))


def _table(n):
    """The kernel's table as complex: W_n^k (k < n), then the pass-1
    factors W_N^(t r), W_N^(8 t q) (``cuda_fft._kernel_table``)."""
    t = cuda_fft._kernel_table(n, torch.device("cpu")).numpy()
    return t[:, 0].astype(np.float64) + 1j * t[:, 1]


def _w256(m):
    return _f32(np.exp(-2j * np.pi * np.asarray(m) / 256))


def _bitrev(x, bits):
    return int(f"{x:0{bits}b}"[::-1], 2) if bits else 0


def _transform(z, n):
    """The register transform of z (N points) -> Z, by the kernel's threads
    and twiddles; asserts that every bin is produced exactly once."""
    N = n // 2
    C = N // 4096
    B, P = 64 * C, 64 * C + C
    tab = _table(n)
    t = np.arange(B)
    # pass 1: column t, the 64-point DFT over j1, times W_N^(t k1)
    cols = z.reshape(64, B)                       # [j1, t]
    y1 = np.fft.fft(cols, axis=0)                 # [k1, t]
    k1 = np.arange(64)[:, None]
    a = tab[n + (k1 % 8) * B + t]                 # W_N^(t r)
    b = tab[n + 8 * B + (k1 // 8) * B + t]        # W_N^(8 t q)
    w = np.where(k1 % 8 == 0, b, np.where(k1 // 8 == 0, a, _f32(a * b)))
    w[0, :] = 1
    y1 = y1 * w
    # the transpose through the buffer
    buf = np.full(64 * P, np.nan, dtype=complex)
    idx = (k1 * P + t).reshape(-1)
    assert len(set(idx)) == idx.size
    buf[idx] = y1.reshape(-1)
    g, jb = t // C, t % C                         # thread u = g C + jb
    ja = np.arange(64)[:, None]
    u2 = buf[g * P + ja * C + jb]                 # [ja, u]
    assert not np.isnan(u2).any()
    # pass 2: the 64-point DFT over ja, times W_256^(jb ka 4 / C)
    ka = np.arange(64)[:, None]
    v = np.fft.fft(u2, axis=0) * _w256(jb * ka * (4 // C))
    # pass 3: the C-point DFT across the lanes jb of each row
    h = C // 2
    while h >= 1:
        p = v[:, t ^ h]
        upper = (jb & h) != 0
        x = np.where(upper, p - v, v + p)
        rot = (h == 2) & (jb == 3)
        v = np.where(rot, -1j * x, x)
        h //= 2
    Z = np.full(N, np.nan, dtype=complex)
    kb = np.array([_bitrev(j, C.bit_length() - 1) for j in jb])
    bins = (g + 64 * ka + 4096 * kb).reshape(-1)
    assert len(set(bins)) == N, "a bin produced twice"
    Z[bins] = v.reshape(-1)
    return Z


def _pack(x, n, lo):
    """z[j] = x[2j] + i x[2j+1] of the row x placed at lo in n zeros."""
    row = np.zeros(n)
    row[lo:lo + x.size] = x
    return row[0::2] + 1j * row[1::2]


def _fwd_model(x, n, lo, bins):
    """real_fwd_kernel on one row x (live samples at lo) -> bins [0, bins)."""
    N = n // 2
    C = N // 4096
    T = 64 * C
    Z = _transform(_pack(x, n, lo), n)
    # the pair buffer: complex, bin k at k + (k >> 12) (16 / C)
    slot = lambda k: k + (k >> 12) * (16 // C)     # noqa: E731
    ks = np.arange(N)
    assert len(set(slot(ks))) == N and slot(ks).max() < 64 * (T + C)
    tab = _table(n)
    w128 = _f32(np.exp(-2j * np.pi * np.arange(32) / 128))
    y = np.full(bins, np.nan, dtype=complex)

    def put(b, val):
        if b < bins:
            assert np.isnan(y[b]), "bin written twice"
            y[b] = val
    for i in range(N // 2 // T):
        for t in range(T):
            k = t + T * i
            za, zb = Z[k], Z[N // 2 if k == 0 else N - k]
            e = (za + np.conj(zb)) / 2
            o = (za - np.conj(zb)) / 2j
            wo = _f32(tab[t] * w128[i]) * o
            if k == 0:
                put(0, za.real + za.imag)
                put(N // 2, np.conj(zb))
                put(n - N // 2, zb)
                put(N, za.real - za.imag)
            else:
                put(k, e + wo)
                put(N - k, np.conj(e - wo))
                put(n - k, np.conj(e + wo))
                put(N + k, e - wo)
    assert not np.isnan(y).any(), "bin never written"
    return y


def _inv_model(Y, n, half):
    """real_inv_kernel on one spectrum Y (n bins, or n/2 + 1 with half)."""
    N = n // 2
    C = N // 4096
    T = 64 * C
    tab = _table(n)
    j = np.arange(N)
    wj = _f32(tab[j % T] * _f32(np.exp(-2j * np.pi * (j // T) / 128)))
    if half:
        A = Y[j].copy()
        B = np.conj(Y[N - j])
        A[0], B[0] = Y[0].real, Y[N].real
    else:
        A = Y[j] + np.conj(Y[(n - j) % n])
        B = Y[N + j] + np.conj(Y[N - j])
    e = A + B
    o = (A - B) * np.conj(wj)
    F = _transform(np.conj(e + 1j * o), n)
    v = np.conj(F) * ((1.0 if half else 0.5) / n)
    out = np.empty(n)
    out[0::2], out[1::2] = v.real, v.imag
    return out


def _rows(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", REAL_N)
def test_transform_model_is_the_fft(n):
    """The register transform alone, on a complex row, against float64."""
    rng = np.random.default_rng(n)
    z = rng.standard_normal(n // 2) + 1j * rng.standard_normal(n // 2)
    ref = np.fft.fft(z)
    assert _rel(_transform(z, n), ref) <= REGS_TOL


@pytest.mark.parametrize("n", REAL_N)
def test_forward_model_matches_jax_kernel(n):
    """The forward with every bin against fft4_fwd(real input) in interpret
    mode (T-layout brought to natural order), and against float64."""
    x = _rows((1, n), n + 11)
    jr, ji = pfft.fft4_fwd(jnp.asarray(x), interpret=True)
    ref = (np.asarray(pfft.t_to_natural(jr))
           + 1j * np.asarray(pfft.t_to_natural(ji)))[0]
    got = _fwd_model(x[0].astype(np.float64), n, 0, n)
    assert _rel(got, ref) <= TOL
    assert _rel(got, np.fft.fft(x[0].astype(np.float64))) <= REGS_TOL


@pytest.mark.parametrize("n", REAL_N)
@pytest.mark.parametrize("span", ["hps", "pef", "odd", "tail"])
def test_forward_model_live_spans(n, span):
    """Rows shorter than n at an offset: HPS's n/8 at 0, PEF's n/4 at an
    even pad, an odd offset with a length no multiple of 16, five samples
    at the end; bins 10,001 (or 3n/4 + 1), n/2 + 1, 1."""
    lo, live = {"hps": (0, n // 8), "pef": (932, n // 4),
                "odd": (931, n // 4 - 5), "tail": (n - 5, 5)}[span]
    x = _rows(live, n + lo).astype(np.float64)
    row = np.zeros(n)
    row[lo:lo + live] = x
    full = np.fft.fft(row)
    peak = np.max(np.abs(full))
    for bins in (min(10001, 3 * n // 4 + 1), n // 2 + 1, 1):
        got = _fwd_model(x, n, lo, bins)
        assert np.max(np.abs(got - full[:bins])) <= REGS_TOL * peak


@pytest.mark.parametrize("n", REAL_N)
@pytest.mark.parametrize("half", [False, True])
def test_inverse_model_matches_jax_kernel(n, half):
    """Re(ifft(Y)) of a random whole spectrum against fft4_inv(out_imag=
    False) in interpret mode; irfft of a random half spectrum against
    jnp.fft.irfft; both against float64."""
    rng = np.random.default_rng(n + half)
    m = n // 2 + 1 if half else n
    yr = rng.standard_normal(m).astype(np.float32)
    yi = rng.standard_normal(m).astype(np.float32)
    Y = yr.astype(np.float64) + 1j * yi
    got = _inv_model(Y, n, half)
    if half:
        ref = np.asarray(jnp.fft.irfft(jnp.asarray(yr + 1j * yi), n))
        ref64 = np.fft.irfft(Y, n)
    else:
        n1 = n // 128
        jr, _ = pfft.fft4_inv(pfft.natural_to_t(jnp.asarray(yr[None]), n1),
                              pfft.natural_to_t(jnp.asarray(yi[None]), n1),
                              out_imag=False, interpret=True)
        ref = np.asarray(jr)[0]
        ref64 = np.fft.ifft(Y).real
    assert _rel(got, ref) <= TOL
    assert _rel(got, ref64) <= REGS_TOL


@pytest.mark.parametrize("mis", range(4))
@pytest.mark.parametrize("lo", [0, 1, 932, 933])
def test_stage_offsets(mis, lo):
    """The forward's staging: a row whose address is `mis` floats past a
    16-byte word sits at stage[s0 ..] with s0 = lo (mod 2), so that a
    point's two samples are one aligned float2; its 16-byte copies need s0
    = mis (mod 4), else every float goes alone (an odd PEF pad with an even
    address).  The head, body and tail of a copy cover the row once, the
    body on 16-byte words at both ends."""
    wide = (mis - lo) % 2 == 0
    s0 = mis if wide else lo & 1
    assert (s0 - lo) % 2 == 0
    for live in (1, 5, 4096, 8191):
        head = min((4 - s0 % 4) % 4, live) if wide else 0
        body = (live - head) & ~3 if wide else 0
        assert (s0 + head) % 4 == 0 or body == 0
        assert (mis + head) % 4 == 0 or body == 0
        covered = np.zeros(live, int)
        covered[:head] += 1
        covered[head:head + body] += 1
        covered[head + body:] += 1
        assert (covered == 1).all()
        # the float2 word of a point with a live sample reads stage[s0 +
        # rel], rel = 2j - lo in [-1, live): even, and inside the live + 8
        # floats of the staging buffer
        rel = np.arange(-(lo % 2), live, 2)
        assert ((s0 + rel) % 2 == 0).all()
        assert (s0 + rel >= 0).all() and (s0 + rel + 1 < live + 8).all()


@pytest.mark.parametrize("n", [4096] + list(REAL_N))
def test_fft_fwd_ref_live_span_matches_jnp(n):
    """``fft_fwd`` (the plain version on the CPU) on rows placed at lo in n
    zeros, at an odd lo, a length no multiple of 16 and the whole row,
    bins 1, 10,001, n/2 + 1 and n, against ``jnp.fft.fft`` of the padded
    rows; ``fft_parts(n=, lo=)`` the same."""
    for lo, live in ((0, n), (7, n // 4 - 3), (0, n // 8)):
        x = _rows((3, live), n + lo + live)
        pad = np.zeros((3, n), np.float32)
        pad[:, lo:lo + live] = x
        ref = np.asarray(jnp.fft.fft(pad))
        for bins in sorted({1, min(10001, n), n // 2 + 1, n}):
            yr, yi = cuda_fft.fft_fwd(torch.from_numpy(x), bins=bins, n=n,
                                      lo=lo)
            assert yr.shape == (3, bins)
            assert _rel(yr.numpy() + 1j * yi.numpy(), ref[:, :bins]) <= 1e-5
            pr, pi = tfft.fft_parts(torch.from_numpy(x), bins=bins, n=n,
                                    lo=lo)
            assert torch.equal(pr, yr) and torch.equal(pi, yi)
    assert cuda_fft.fft_fwd.launches == 0


def test_live_span_checks():
    """A span that does not fit n, a negative lo, and n or lo with complex
    rows raise."""
    x = torch.zeros(2, 4096)
    for kw in (dict(n=8192, lo=4097), dict(n=8192, lo=-1),
               dict(n=2048), dict(n=8192, lo=0, xi=x)):
        with pytest.raises(ValueError):
            cuda_fft.fft_fwd(x, **kw)


@pytest.mark.parametrize("n", [2048] + list(REAL_N))
def test_half_inverse_matches_irfft(n):
    """``fft_inv(yr, yi, n=n)``, ``ifft_parts(n=)`` and ``ops.fft.irfft`` on
    a half spectrum with nonzero imaginary parts at DC and Nyquist (dropped,
    as irfft drops them) against ``jnp.fft.irfft``; a wrong count of bins
    raises."""
    h = n // 2 + 1
    yr, yi = _rows((2, h), n), _rows((2, h), n + 1)
    ref = np.asarray(jnp.fft.irfft(jnp.asarray(yr + 1j * yi), n))
    tr, ti = torch.from_numpy(yr), torch.from_numpy(yi)
    got, none = cuda_fft.fft_inv(tr, ti, n=n)
    assert none is None and got.shape == (2, n)
    assert _rel(got.numpy(), ref) <= 1e-5
    assert torch.equal(tfft.ifft_parts(tr, ti, n=n), got)
    assert _rel(tfft.irfft(torch.complex(tr, ti), n=n).numpy(), ref) <= 1e-5
    with pytest.raises(ValueError):
        cuda_fft.fft_inv(tr[..., :-1], ti[..., :-1], n=n)


def _clips(seed, k=2, seconds=1.0, sr=32000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 180.0 + 40.0 * np.arange(k)[:, None]
    tone = np.sin(2 * np.pi * f0 * t) + 0.4 * np.sin(4 * np.pi * f0 * t)
    return (0.5 * tone + 0.05 * rng.standard_normal(tone.shape)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["hps", "lhs", "pef"])
def test_pitch_engines_match_jax(name):
    """HPS, LHS and PEF (their FFTs on the live span, PEF's product and
    inverse on the half spectrum) against the JAX package's engines at
    radix2_exp 11, frame for frame."""
    jcls, tcls = {"hps": (af.PitchHPS, aft.PitchHPS),
                  "lhs": (af.PitchLHS, aft.PitchLHS),
                  "pef": (af.PitchPEF, aft.PitchPEF)}[name]
    kw = dict(samplate=32000, radix2_exp=11, slide_length=1024)
    x = _clips(7)
    got = tcls(**kw, **CPU).pitch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcls(**kw).pitch(x)),
                               atol=1e-3)


def test_pef_half_spectrum_path_equals_padded_path():
    """PEF's cross-correlation from the live span (half spectrum) equals
    the one from the padded buffer (whole spectrum) on the CPU."""
    plan = aft.PitchPEF(samplate=32000, radix2_exp=11, **CPU)
    x = torch.from_numpy(_clips(8))
    X = plan.xcorr_fft_length
    hr, hi = plan._xcorr_spectrum(plan._log_power(x))
    fr, fi = plan._xcorr_spectrum(plan._xcorr_rows(x))
    assert hr.shape[-1] == X // 2 + 1 and fr.shape[-1] == X
    assert torch.equal(hr, fr[..., :X // 2 + 1])
    assert torch.equal(hi, fi[..., :X // 2 + 1])
    assert torch.equal(tfft.ifft_parts(hr, hi, n=X),
                       tfft.ifft_parts(fr, fi, real_only=True))


@pytest.mark.parametrize("n_sig", [1000, 4096, 5000])
@pytest.mark.parametrize("cross", [False, True])
def test_xcorr_matches_jax(n_sig, cross):
    """``xcorr`` (live-span forwards, the half product, the half inverse)
    against the JAX package's at 5e-5 of the peak: transforms of 2048,
    8192 and 16384."""
    rng = np.random.default_rng(n_sig + cross)
    a = rng.standard_normal((2, n_sig)).astype(np.float32)
    b = rng.standard_normal((2, n_sig)).astype(np.float32) if cross else None
    from audioflux_tpu.dsp import xcorr as jx
    from audioflux_torch.dsp import xcorr as tx
    ref, ri, rv = jx(a, b)
    got, gi, gv = tx(a, b, device="cpu")
    assert _rel(got.numpy(), np.asarray(ref)) <= TOL
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
