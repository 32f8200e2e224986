"""The port's unwrap + difference on the CPU (its plain version) against
the JAX package: the fused Pallas kernel in interpret mode and the prefix-
sum form of transforms/synsq.py.

Contract (tests/test_pallas_unwrap.py): the wrap counts agree exactly; the
interpret-mode Pallas kernel may contract the final x + c * 2 pi into a
multiply-add, so against it a cell may differ by up to 2 ulp of the
unwrapped phase.  The port's plain version makes each fp32 operation on
its own, as the JAX prefix-sum form run op by op does, so those two agree
bit for bit (required here on >= 99.9% of the cells)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops.pallas_unwrap import unwrap_diff as j_unwrap_diff
from audioflux_tpu.transforms.synsq import _c_unwrap as j_c_unwrap
from audioflux_torch.ops import _build
from audioflux_torch.ops.cuda_unwrap import (c_unwrap, unwrap_diff,
                                             unwrap_diff_ref)

ROWS, T = 16, 512


def _phases(kind):
    rng = np.random.default_rng(0)
    if kind == "wrapping":   # large steps both ways, far past 2 pi
        t = np.cumsum(rng.uniform(-2.5, 3.0, (ROWS, T)), axis=-1)
    elif kind == "drifting":  # a slow one-way drift with jitter
        t = np.cumsum(0.3 + 0.05 * rng.standard_normal((ROWS, T)), axis=-1)
    else:                     # steady near-pi increments: the knife edge
        t = np.outer(np.ones(ROWS) * 3.1, np.arange(T))
    return np.float32(np.arctan2(np.sin(t), np.cos(t)))


def _jax_cumsum_form(x):
    ph = np.asarray(j_c_unwrap(jnp.asarray(x)))
    e = np.zeros_like(x)
    e[..., 1:] = ph[..., 1:] - ph[..., :-1]
    return ph, e


@pytest.mark.parametrize("kind", ["wrapping", "drifting", "steady"])
def test_ref_matches_pallas_interpret(kind):
    x = _phases(kind)
    got = unwrap_diff_ref(torch.from_numpy(x)).numpy()
    want = np.asarray(j_unwrap_diff(jnp.asarray(x), interpret=True))
    ph, _ = _jax_cumsum_form(x)
    tol = 2 * np.finfo(np.float32).eps * np.abs(ph).max()
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - want).max() < 1.0     # a wrong count is 2 pi off
    assert got[..., 0].max() == got[..., 0].min() == 0.0


@pytest.mark.parametrize("kind", ["wrapping", "drifting", "steady"])
def test_ref_matches_jax_cumsum_form(kind):
    x = _phases(kind)
    ph, want = _jax_cumsum_form(x)
    got_ph = c_unwrap(torch.from_numpy(x)).numpy()
    got = unwrap_diff_ref(torch.from_numpy(x)).numpy()
    tol = 2 * np.finfo(np.float32).eps * np.abs(ph).max()
    assert np.abs(got - want).max() <= tol
    assert (got_ph == ph).mean() >= 0.999
    assert (got == want).mean() >= 0.999
    if kind == "wrapping":     # the unwrapped phase really leaves [-pi, pi]
        assert np.abs(ph).max() > 50


def test_unwrap_is_continuous():
    """After the unwrap no step exceeds pi (up to rounding), whatever the
    wrapped input did."""
    y = c_unwrap(torch.from_numpy(_phases("wrapping"))).numpy()
    assert np.abs(np.diff(y, axis=-1)).max() <= np.pi + 1e-4


def test_short_rows():
    one = unwrap_diff(torch.tensor([[1.5]]))
    assert one.shape == (1, 1) and float(one) == 0.0
    two = unwrap_diff(torch.tensor([[3.0, -3.0]]))
    np.testing.assert_allclose(two.numpy(), [[0.0, 2 * np.pi - 6.0]],
                               atol=1e-6)


def test_cpu_tensor_runs_plain_version_without_a_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    x = torch.from_numpy(_phases("wrapping"))
    before = unwrap_diff.launches
    assert torch.equal(unwrap_diff(x), unwrap_diff_ref(x))
    assert unwrap_diff.launches == before
    with pytest.raises(TypeError):
        unwrap_diff(x.double())
    with pytest.raises(ValueError):
        unwrap_diff(x[0])
