"""The port's sliding median (plain version of the CUDA kernel and
``ops.filter``) against the JAX package: the Pallas kernel in interpret
mode and ``ops.filter.median_filter``, value for value."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops import filter as jfilter
from audioflux_tpu.ops.pallas_median import median_filter_last_axis as jmedian
from audioflux_torch.ops import cuda_median
from audioflux_torch.ops import filter as tfilter


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    x[x < 0.3] = 0.0          # ties and exact zeros, like a magnitude
    return x


@pytest.mark.parametrize("order", [3, 9, 21, 31, 35])
def test_median_matches_pallas_interpret(order):
    """Wrapper and plain version equal the interpret-mode Pallas kernel and
    the jnp full sort on every value."""
    x = _data((11, 150), order)
    ref_kernel = np.asarray(jmedian(jnp.asarray(x), order, interpret=True))
    ref_jnp = np.asarray(jfilter.median_filter(jnp.asarray(x), order))
    assert np.array_equal(ref_kernel, ref_jnp)
    tx = torch.from_numpy(x)
    for fn in (cuda_median.median_filter_last_axis,
               cuda_median.median_filter_last_axis_ref,
               tfilter.median_filter):
        got = fn(tx, order).numpy()
        assert got.shape == x.shape
        assert np.array_equal(got, ref_kernel), fn.__name__


@pytest.mark.parametrize("order", [0, 1, 4, 22])
def test_median_even_or_trivial_order_returns_input(order):
    tx = torch.from_numpy(_data((3, 40), 1))
    assert cuda_median.median_filter_last_axis(tx, order) is tx
    assert tfilter.median_filter(tx, order) is tx
    assert np.array_equal(np.asarray(jmedian(jnp.asarray(tx.numpy()), order)),
                          tx.numpy())


@pytest.mark.parametrize("shape", [(4, 7), (5, 1), (17,), (2, 3, 50)])
def test_median_short_rows_and_nd(shape):
    """Rows shorter than the order, one-column rows, 1-D and 3-D input."""
    x = _data(shape, len(shape))
    for order in (9, 21):
        ref = np.asarray(jmedian(jnp.asarray(x), order, interpret=True))
        got = cuda_median.median_filter_last_axis(torch.from_numpy(x), order)
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dim", [0, 1, -2, -1])
def test_median_along_any_axis(dim):
    """``dim`` equals the JAX package's swapaxes around the last-axis
    filter (how its HPSS filters along time)."""
    x = _data((6, 40, 9), 5)
    ref = np.asarray(jfilter.median_filter(jnp.asarray(x), 7, axis=dim))
    swapped = jnp.swapaxes(
        jmedian(jnp.swapaxes(jnp.asarray(x), dim, -1), 7, interpret=True),
        dim, -1)
    assert np.array_equal(ref, np.asarray(swapped))
    for fn in (cuda_median.median_filter_last_axis, tfilter.median_filter):
        got = fn(torch.from_numpy(x), 7, dim)
        assert got.is_contiguous()
        assert np.array_equal(got.numpy(), ref)


def test_median_checks_inputs_and_tile():
    x = torch.zeros(4, 64)
    with pytest.raises(TypeError):
        cuda_median.median_filter_last_axis(x.double(), 5)
    with pytest.raises(ValueError):
        cuda_median.median_filter_last_axis(x.T, 5)
    with pytest.raises(ValueError):
        cuda_median.median_filter_last_axis(torch.zeros(()), 5)
    assert cuda_median.median_filter_last_axis.launches == 0
    # the block's tile: a warp's width along the inner axis, shrunk until
    # the staged span fits a block's shared memory
    assert cuda_median._tile(31, 1) == (1024, 1)
    assert cuda_median._tile(21, 1025) == (32, 32)
    assert cuda_median._tile(21, 3) == (256, 4)
    tl, ti = cuda_median._tile(4001, 1025)
    assert 4 * (tl + 4000) * ti <= 227 * 1024 and ti < 32
    with pytest.raises(ValueError):
        cuda_median._tile(100001, 1)


@pytest.mark.parametrize("order", [1, 2, 5, 8])
def test_max_filter_matches_jax(order):
    x = _data((3, 30, 4), order) - 0.5
    for dim in (-1, 1):
        ref = np.asarray(jfilter.max_filter(jnp.asarray(x), order, axis=dim))
        got = tfilter.max_filter(torch.from_numpy(x), order, dim)
        assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(
        tfilter.max_filter(torch.from_numpy(x), 0).numpy(), x)
