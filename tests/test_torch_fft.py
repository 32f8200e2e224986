"""The port's FFT (plain version of the CUDA kernel, and the ``ops.fft``
tiers) against the JAX package: ``fft4_fwd`` in Pallas interpret mode and
``jnp.fft``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops import pallas_fft as pfft
from audioflux_torch.ops import cuda_fft
from audioflux_torch.ops import fft as tfft


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("complex_in", [False, True])
def test_fft_fwd_matches_pallas_interpret(n, complex_in):
    """Natural-order plain version vs fft4_fwd (T-layout) + t_to_natural,
    within the kernel's 5e-5-of-peak contract."""
    rng = np.random.default_rng(n + complex_in)
    xr = rng.standard_normal((3, n)).astype(np.float32)
    xi = rng.standard_normal((3, n)).astype(np.float32) if complex_in else None
    jr, ji = pfft.fft4_fwd(jnp.asarray(xr),
                           None if xi is None else jnp.asarray(xi),
                           interpret=True)
    ref = (np.asarray(pfft.t_to_natural(jr))
           + 1j * np.asarray(pfft.t_to_natural(ji)))
    args = (torch.from_numpy(xr),) + (
        () if xi is None else (torch.from_numpy(xi),))
    for fn in (cuda_fft.fft_fwd_ref, cuda_fft.fft_fwd):
        yr, yi = fn(*args)
        got = yr.numpy() + 1j * yi.numpy()
        assert got.shape == (3, n)
        assert _rel(got, ref) <= 5e-5, fn.__name__


def test_fft_fwd_checks_inputs():
    x = torch.zeros(2, 2048)
    for bad in (torch.zeros(2, 1024), torch.zeros(2, 3000),
                torch.zeros(2, 65536)):
        with pytest.raises(ValueError):
            cuda_fft.fft_fwd(bad)
    with pytest.raises(TypeError):
        cuda_fft.fft_fwd(x.double())
    with pytest.raises(ValueError):
        cuda_fft.fft_fwd(torch.zeros(2048, 2).T)
    with pytest.raises(ValueError):
        cuda_fft.fft_fwd(x, torch.zeros(1, 2048))
    assert [n for n in (1024, 2048, 3072, 32768, 65536)
            if cuda_fft.supports(n)] == [2048, 32768]


def test_twiddle_table():
    tw = cuda_fft.twiddle_table(2048, torch.device("cpu")).numpy()
    ref = np.exp(-2j * np.pi * np.arange(2048) / 2048)
    assert tw.shape == (2048, 2) and tw.dtype == np.float32
    assert np.max(np.abs(tw[:, 0] + 1j * tw[:, 1] - ref)) <= 6e-8


@pytest.mark.parametrize("n", [512, 2048, 3000, 4096])
def test_ops_fft_matches_jnp(n):
    """Both tiers (kernel tier at pow2 2048..32768, torch.fft elsewhere),
    along a non-last axis, with padding and trimming."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n - 100, 3)).astype(np.float32)
    z = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    for exact in (False, True):
        got = tfft.rfft(tx, n=n, dim=0, exact=exact).numpy()
        assert got.shape == (n // 2 + 1, 3)
        assert _rel(got, np.asarray(jnp.fft.rfft(x, n=n, axis=0))) <= 1e-5
        got = tfft.fft(tz, n=n, dim=0, exact=exact).numpy()
        assert _rel(got, np.asarray(jnp.fft.fft(z, n=n, axis=0))) <= 1e-5
        got = tfft.fft(tx[: n // 2], n=n, dim=0, exact=exact).numpy()
        assert _rel(got, np.asarray(jnp.fft.fft(x[: n // 2], n=n,
                                                axis=0))) <= 1e-5
    spec = np.array(jnp.fft.rfft(x, n=n, axis=0))
    got = tfft.irfft(torch.from_numpy(spec), n=n, dim=0).numpy()
    assert _rel(got, np.asarray(jnp.fft.irfft(spec, n=n, axis=0))) <= 1e-5
    got = tfft.ifft(tz, dim=0).numpy()
    assert _rel(got, np.asarray(jnp.fft.ifft(z, axis=0))) <= 1e-5


def test_rfft_last_axis_trims():
    x = np.random.default_rng(5).standard_normal((2, 5000)).astype(np.float32)
    got = tfft.rfft(torch.from_numpy(x), n=4096).numpy()
    assert _rel(got, np.asarray(jnp.fft.rfft(x, n=4096))) <= 1e-5


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("out_imag", [True, False])
def test_fft_inv_matches_pallas_interpret(n, out_imag):
    """Natural-order inverse vs fft4_inv fed the same spectrum in T-layout,
    within the kernel's 5e-5-of-peak contract."""
    rng = np.random.default_rng(n + out_imag)
    yr = rng.standard_normal((3, n)).astype(np.float32)
    yi = rng.standard_normal((3, n)).astype(np.float32)
    n1 = n // 128
    jr, ji = pfft.fft4_inv(pfft.natural_to_t(jnp.asarray(yr), n1),
                           pfft.natural_to_t(jnp.asarray(yi), n1),
                           out_imag=out_imag, interpret=True)
    assert (ji is None) == (not out_imag)
    ref64 = np.fft.ifft(yr.astype(np.float64) + 1j * yi)
    for fn in (cuda_fft.fft_inv_ref, cuda_fft.fft_inv):
        xr, xi = fn(torch.from_numpy(yr), torch.from_numpy(yi),
                    out_imag=out_imag)
        assert xr.shape == (3, n) and xr.is_contiguous()
        assert _rel(xr.numpy(), np.asarray(jr)) <= 5e-5, fn.__name__
        assert _rel(xr.numpy(), ref64.real) <= 5e-5
        if out_imag:
            assert _rel(xi.numpy(), np.asarray(ji)) <= 5e-5
            assert _rel(xi.numpy(), ref64.imag) <= 5e-5
        else:
            assert xi is None


def test_fft_inv_round_trip_and_checks():
    rng = np.random.default_rng(7)
    xr = torch.from_numpy(rng.standard_normal((2, 3, 2048)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((2, 3, 2048)).astype(np.float32))
    br, bi = cuda_fft.fft_inv(*cuda_fft.fft_fwd(xr, xi))
    assert float((br - xr).abs().max()) <= 5e-5 * float(xr.abs().max())
    assert float((bi - xi).abs().max()) <= 5e-5 * float(xr.abs().max())
    for fn in (cuda_fft.fft_inv, cuda_fft.fft_autocorr):
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 1024), torch.zeros(2, 1024))
        with pytest.raises(TypeError):
            fn(xr.double(), xi.double())
        with pytest.raises(ValueError):
            fn(xr, xi[:1])
        with pytest.raises(ValueError):
            fn(xr, torch.zeros(2, 2048, 3).transpose(-1, -2))
    assert cuda_fft.fft_inv.launches == 0 and cuda_fft.fft_autocorr.launches == 0


@pytest.mark.parametrize("n", [2048, 4096])
def test_fft_autocorr_matches_pallas_interpret(n):
    """0.5*Im(ifft(fft(x + iy)^2)) vs the fused Pallas kernel and float64
    numpy, 5e-5 of the peak (tests/test_pallas_fft.py's contract)."""
    rng = np.random.default_rng(91 + n)
    x = rng.standard_normal((5, n)).astype(np.float32)
    y = rng.standard_normal((5, n)).astype(np.float32)
    Z = np.fft.fft(x.astype(np.float64) + 1j * y.astype(np.float64))
    ref64 = 0.5 * np.imag(np.fft.ifft(Z * Z))
    jref = np.asarray(pfft.fft4_autocorr(jnp.asarray(x), jnp.asarray(y),
                                         interpret=True))
    for fn in (cuda_fft.fft_autocorr_ref, cuda_fft.fft_autocorr):
        got = fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert got.shape == (5, n)
        assert _rel(got, ref64) <= 5e-5, fn.__name__
        assert _rel(got, jref) <= 5e-5, fn.__name__
    # it is the circular convolution of x with y
    conv = np.fft.irfft(np.fft.rfft(x.astype(np.float64))
                        * np.fft.rfft(y.astype(np.float64)), n=n)
    assert _rel(got, conv) <= 5e-5


@pytest.mark.parametrize("n", [512, 2048, 3000, 4096])
def test_ops_inverse_tiers(n):
    """ifft / irfft in and out of the kernel tier against torch.fft and
    float64 numpy: along a non-last axis, zero-padded, trimmed, and with
    exact=True pinning torch.fft."""
    rng = np.random.default_rng(n)
    z = (rng.standard_normal((n - 100, 3))
         + 1j * rng.standard_normal((n - 100, 3))).astype(np.complex64)
    tz = torch.from_numpy(z)
    m = n // 2 + 1
    half = (rng.standard_normal((m + 5, 3))
            + 1j * rng.standard_normal((m + 5, 3))).astype(np.complex64)
    th = torch.from_numpy(half)
    for exact in (False, True):
        got = tfft.ifft(tz, n=n, dim=0, exact=exact).numpy()
        assert got.shape == (n, 3)
        assert _rel(got, np.fft.ifft(z.astype(np.complex128), n=n,
                                     axis=0)) <= 1e-5
        assert _rel(got, torch.fft.ifft(tz, n=n, dim=0).numpy()) <= 1e-5
        # trimmed to m bins (m + 5 given) and padded (m - 7 given)
        for k in (m + 5, m - 7):
            got = tfft.irfft(th[:k], n=n, dim=0, exact=exact).numpy()
            assert got.shape == (n, 3)
            assert _rel(got, torch.fft.irfft(th[:k], n=n,
                                             dim=0).numpy()) <= 1e-5
            assert _rel(got, np.asarray(jnp.fft.irfft(half[:k], n=n,
                                                      axis=0))) <= 1e-5
    # last axis, n implied by the input
    spec = torch.from_numpy(np.ascontiguousarray(half[:m].T))
    got = tfft.irfft(spec).numpy()
    assert got.shape == (3, 2 * (m - 1))
    assert _rel(got, torch.fft.irfft(spec).numpy()) <= 1e-5
    got = tfft.ifft(torch.from_numpy(np.ascontiguousarray(z.T))).numpy()
    assert _rel(got, np.fft.ifft(z.T.astype(np.complex128))) <= 1e-5


@pytest.mark.parametrize("n", [1024, 2048])
def test_irfft_hermitian_inconsistent_input(n):
    """Nonzero imaginary parts in the DC and Nyquist bins are dropped, in
    and out of the kernel tier, as torch.fft.irfft and jnp.fft.irfft do."""
    rng = np.random.default_rng(n)
    spec = (rng.standard_normal((2, n // 2 + 1))
            + 1j * rng.standard_normal((2, n // 2 + 1))).astype(np.complex64)
    assert spec[0, 0].imag != 0 and spec[0, -1].imag != 0
    clean = spec.copy()
    clean[:, 0] = clean[:, 0].real
    clean[:, -1] = clean[:, -1].real
    got = tfft.irfft(torch.from_numpy(spec), n=n).numpy()
    assert _rel(got, np.fft.irfft(clean.astype(np.complex128), n=n)) <= 1e-5
    assert _rel(got, np.asarray(jnp.fft.irfft(spec, n=n))) <= 1e-5
    # a real-valued "spectrum" is accepted too
    real_spec = torch.from_numpy(np.ascontiguousarray(spec.real))
    got = tfft.irfft(real_spec, n=n).numpy()
    assert _rel(got, np.fft.irfft(spec.real.astype(np.float64), n=n)) <= 1e-5
