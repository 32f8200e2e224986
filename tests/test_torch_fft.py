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
