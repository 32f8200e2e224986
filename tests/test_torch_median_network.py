"""The median kernel's selection networks (``ops/median_network.py``): the
very list of operations that the generated header hands the CUDA kernel,
applied with numpy, against a sort-based median cell for cell.

* random values, heavy ties, runs of zeros, negatives and ±inf at every
  odd order 3..33 and runs of m = 1, 2, 4, 8, 16 windows;
* exhaustively over all 0-1 inputs where a run has at most 12 taps (a
  network of min/max is right on every input if it is right on every 0-1
  input);
* whole sliding medians cut into runs as the kernel cuts them (zero
  padding, a last run past the row's end) against the wrapper's plain
  version and the JAX package's Pallas kernel in interpret mode;
* the generated C++ parsed back and run, so the header is the network;
* the compare-exchanges an output at the HPSS orders, against the 149 and
  157 of one window a thread.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioflux_tpu.ops.pallas_median import median_filter_last_axis as jmedian
from audioflux_torch.ops import cuda_median
from audioflux_torch.ops import median_network as mn

ORDERS = list(range(3, 34, 2))
RUNS = [1, 2, 4, 8, 16]


def _sorted_medians(taps, order, m):
    """(..., order + m - 1) taps -> (..., m) medians by a full sort."""
    return np.stack([np.sort(taps[..., j:j + order], axis=-1)[..., order // 2]
                     for j in range(m)], axis=-1)


def _inputs(n_taps, seed):
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((64, n_taps)),                  # distinct
            rng.integers(-2, 3, (64, n_taps)).astype(float),    # heavy ties
            np.where(rng.random((64, n_taps)) < 0.6, 0.0,       # zero runs
                     rng.standard_normal((64, n_taps)))]
    special = rng.choice(np.array([np.inf, -np.inf, -0.0, 0.0, -1.5, 2.5]),
                         (64, n_taps))
    rows.append(special)
    return np.concatenate(rows).astype(np.float32)


@pytest.mark.parametrize("m", RUNS)
def test_network_equals_sort(m):
    for order in ORDERS:
        net = mn.build(order, m)
        assert net.n_taps == order + m - 1 and len(net.outputs) == m
        x = _inputs(net.n_taps, order * 100 + m)
        got = mn.apply(net, x)
        want = _sorted_medians(x, order, m)
        assert np.array_equal(got, want), (order, m)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_network_zero_one_exhaustive(m):
    """Every 0-1 input of every (order, m) with at most 12 taps (none at
    m = 16: order 3 alone has 18)."""
    checked = 0
    for order in ORDERS:
        net = mn.build(order, m)
        if net.n_taps > 12:
            continue
        x = np.array(list(itertools.product((0.0, 1.0), repeat=net.n_taps)),
                     dtype=np.float32)
        assert np.array_equal(mn.apply(net, x), _sorted_medians(x, order, m))
        checked += 1
    assert checked >= 1


def _runs_model(x, order, m):
    """The kernel's cut of a last-axis median into runs: row position l of
    run r is tap l - r m + order // 2; zeros outside the row; the outputs
    past the row's end are dropped."""
    rows, length = x.shape
    half = order // 2
    runs = -(-length // m)
    net = mn.build(order, m)
    padded = np.zeros((rows, runs * m + 2 * half), dtype=np.float32)
    padded[:, half:half + length] = x
    taps = np.stack([padded[:, r * m:r * m + net.n_taps]
                     for r in range(runs)], axis=1)
    return mn.apply(net, taps).reshape(rows, runs * m)[:, :length]


@pytest.mark.parametrize("order", [21, 31])
@pytest.mark.parametrize("m", [4, 8, mn.RUN])
def test_kernel_instances_slide_like_the_wrapper(order, m):
    """Rows longer and shorter than the run and the order, against the
    plain version and the Pallas kernel in interpret mode: the kernel's run
    (``RUN``) and shorter runs of the same construction."""
    rng = np.random.default_rng(order + m)
    for length in (1, 5, m + 3, order + 2, 150):
        x = np.abs(rng.standard_normal((3, length))).astype(np.float32)
        x[x < 0.3] = 0.0
        got = _runs_model(x, order, m)
        ref = cuda_median.median_filter_last_axis_ref(torch.from_numpy(x),
                                                      order).numpy()
        assert np.array_equal(got, ref), length
        if length == 150:
            pallas = np.asarray(jmedian(jnp.asarray(x), order,
                                        interpret=True))
            assert np.array_equal(got, pallas)


def _parse_header(text, order, m):
    """The straight-line C++ of MedianRun<order, m> run on numpy taps."""
    body = text.split(f"struct MedianRun<{order}, {m}> {{")[1]
    body = body.split("\n};")[0]
    val = r"(\w+(?:\[\d+\])?)"
    stmt = re.compile(rf"const float v(\d+) = (fminf|fmaxf)\({val}, {val}\);")
    out = re.compile(rf"y\[(\d+)\] = {val};")

    def run(t):
        env = {f"t[{i}]": t[..., i] for i in range(t.shape[-1])}
        y = {}
        for line in body.splitlines():
            s = stmt.search(line)
            if s:
                fn = np.minimum if s.group(2) == "fminf" else np.maximum
                env[f"v{s.group(1)}"] = fn(env[s.group(3)], env[s.group(4)])
                continue
            o = out.search(line)
            if o:
                y[int(o.group(1))] = env[o.group(2)]
        return np.stack([y[j] for j in range(m)], axis=-1)
    return run


def test_generated_header_is_the_network():
    text = mn.header_text()
    assert f"constexpr int kMedianRun = {mn.RUN};" in text
    assert mn.INSTANCES == ((21, mn.RUN), (31, mn.RUN))
    for order, m in mn.INSTANCES:
        net = mn.build(order, m)
        assert f"static constexpr int kMinMax = {net.minmax};" in text
        x = _inputs(net.n_taps, 7)
        assert np.array_equal(_parse_header(text, order, m)(x),
                              mn.apply(net, x)), (order, m)


def test_operation_counts():
    """Compare-exchanges an output at HPSS's orders, runs of 8, against
    one window a thread (149 at order 21, 157 at order 31)."""
    assert mn.batcher_single_count(21) == 149
    assert mn.batcher_single_count(31) == 157
    n21, n31 = mn.build(21, 8), mn.build(31, 8)
    assert (n21.compare_exchanges, n21.minmax) == (133, 212)
    assert (n31.compare_exchanges, n31.minmax) == (199, 334)
    assert n21.ce_per_output < 149 and n31.ce_per_output < 157
    assert n21.minmax_per_output < 2 * 149 and n31.minmax_per_output < 2 * 157
    # longer runs share more
    for order in (21, 31):
        per = [mn.build(order, m).minmax_per_output for m in (4, 8, 16)]
        assert per == sorted(per, reverse=True)
    assert cuda_median.has_network(21) and cuda_median.has_network(31)
    assert not cuda_median.has_network(33)


def test_build_rejects():
    for order, m in ((0, 8), (4, 8), (21, 0)):
        with pytest.raises(ValueError):
            mn.build(order, m)
    with pytest.raises(ValueError):
        mn.apply(mn.build(5, 2), np.zeros((3, 5)))
