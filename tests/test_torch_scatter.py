"""The port's scatter-adds on the CPU against the JAX package: the columnar
form against the one-hot einsum and the Pallas kernel in interpret mode
(all three add a bin's cells in ascending input row, so the sums are equal
bit for bit, tests/test_pallas_scatter.py), the flat batched form at
1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops.pallas_scatter import columnar_scatter_pallas
from audioflux_tpu.ops.scatter import batched_scatter_add as j_batched
from audioflux_tpu.ops.scatter import columnar_scatter_add as j_columnar
from audioflux_torch.ops import _build
from audioflux_torch.ops.cuda_scatter import (columnar_scatter,
                                              columnar_scatter_ref)
from audioflux_torch.ops.scatter import (batched_scatter_add,
                                         columnar_scatter_add)


def _case(seed, shape, F, lo=0):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    # indices include the drop bin F and heavy duplicates
    fi = rng.integers(lo, F + 1, shape).astype(np.int32)
    return v, fi


@pytest.mark.parametrize("name,shape,F", [
    ("square", (3, 84, 256), 84),        # R = F = 84, the synsq shape
    ("rect", (1, 16, 128), 40),          # out bins != in rows
    ("narrow_out", (2, 40, 128), 8),
])
def test_ref_equals_jax_columnar_and_pallas(name, shape, F):
    v, fi = _case(len(name), shape, F)
    got = columnar_scatter_ref(torch.from_numpy(v), torch.from_numpy(fi),
                               F).numpy()
    xla = np.asarray(j_columnar(jnp.asarray(v), jnp.asarray(fi), F))
    pallas = np.asarray(columnar_scatter_pallas(
        jnp.asarray(v), jnp.asarray(fi), F, interpret=True))
    assert got.shape == (shape[0], F, shape[2]) and got.dtype == np.complex64
    assert np.array_equal(got, xla)
    assert np.array_equal(got, pallas)


def test_all_dropped_and_negative_indices():
    v = np.ones((2, 8, 128), np.complex64)
    full = torch.full((2, 8, 128), 8, dtype=torch.int32)   # the trash bin
    assert not columnar_scatter_ref(torch.from_numpy(v), full, 8).any()
    v, fi = _case(5, (2, 8, 64), 8, lo=-3)                  # negatives drop
    got = columnar_scatter_ref(torch.from_numpy(v), torch.from_numpy(fi),
                               8).numpy()
    want = np.asarray(j_columnar(jnp.asarray(v), jnp.asarray(fi), 8))
    assert np.array_equal(got, want)


def test_columnar_scatter_add_leading_axes():
    """The dispatcher flattens any leading axes and takes any integer
    index type."""
    v, fi = _case(7, (2, 3, 12, 32), 20)
    got = columnar_scatter_add(torch.from_numpy(v),
                               torch.from_numpy(fi).long(), 20).numpy()
    want = np.asarray(j_columnar(jnp.asarray(v), jnp.asarray(fi), 20))
    assert got.shape == (2, 3, 20, 32)
    assert np.array_equal(got, want)
    v1, fi1 = _case(8, (12, 32), 20)                        # no batch axis
    got = columnar_scatter_add(torch.from_numpy(v1), torch.from_numpy(fi1),
                               20).numpy()
    assert np.array_equal(got, np.asarray(
        j_columnar(jnp.asarray(v1), jnp.asarray(fi1), 20)))


@pytest.mark.parametrize("cpx", [True, False])
def test_batched_scatter_add_matches_jax(cpx):
    rng = np.random.default_rng(3)
    n, out_size = 5000, 700
    v = rng.standard_normal((2, 3, n)).astype(np.float32)
    if cpx:
        v = (v + 1j * rng.standard_normal((2, 3, n))).astype(np.complex64)
    idx = rng.integers(-5, out_size + 5, (2, 3, n)).astype(np.int32)
    got = batched_scatter_add(torch.from_numpy(v), torch.from_numpy(idx),
                              out_size).numpy()
    want = np.asarray(j_batched(jnp.asarray(v), jnp.asarray(idx), out_size))
    assert got.shape == (2, 3, out_size) and got.dtype == v.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_batched_equals_columnar():
    """The flat form with index f * T + t computes the columnar sum."""
    v, fi = _case(9, (2, 30, 50), 30)
    T = 50
    flat = np.where(fi < 30, fi * T + np.arange(T), 30 * T)
    a = batched_scatter_add(torch.from_numpy(v).reshape(2, -1),
                            torch.from_numpy(flat).reshape(2, -1), 30 * T)
    b = columnar_scatter_ref(torch.from_numpy(v), torch.from_numpy(fi), 30)
    np.testing.assert_allclose(a.reshape(2, 30, T).numpy(), b.numpy(),
                               atol=1e-5)


def test_cpu_tensor_runs_plain_version_without_a_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    v, fi = _case(1, (2, 84, 64), 84)
    v, fi = torch.from_numpy(v), torch.from_numpy(fi)
    before = columnar_scatter.launches
    got = columnar_scatter(v, fi, 84)
    assert torch.equal(torch.view_as_real(got),
                       torch.view_as_real(columnar_scatter_ref(v, fi, 84)))
    assert columnar_scatter.launches == before
    # the plain version has no ceiling on out_size; the wrapper checks types
    assert columnar_scatter(v, fi, 600).shape == (2, 600, 64)
    with pytest.raises(TypeError):
        columnar_scatter(v, fi.long(), 84)
    with pytest.raises(ValueError):
        columnar_scatter(v, fi[:, :4], 84)
