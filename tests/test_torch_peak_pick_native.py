"""The onset peak pick's compiled pass (``audioflux_torch/csrc/
peak_pick.cpp``, built with g++ on the CPU): its points against the numpy
form it replaced (``peak_pick_ref``) and the JAX package's ``peak_pick``,
equal on fuzzed float32 rows; its window means against numpy's, bit for
bit; the route and its counter; the shared g++ build."""

import numpy as np
import pytest

from audioflux_torch.mir import onset as to
from audioflux_torch.ops import _build
from audioflux_tpu.mir import onset as jo

LENGTHS = (0, 1, 2, 7, 13, 14, 937, 18747)
# (pre_max, post_max, pre_avg, post_avg, wait, delta): the mir cell's
# windows, test_torch_onset.py's three, a mean window under 8 rows and one
# over 128
WINDOWS = ((1, 1, 6, 7, 1, 0.07), (3, 1, 10, 11, 3, 0.07),
           (0, 1, 0, 1, 0, 0.0), (2, 2, 40, 3, 1, 0.01),
           (2, 1, 3, 2, 2, 0.05), (4, 2, 100, 60, 3, 0.02))
KINDS = ("uniform", "quarters", "spiky", "constant", "nans")


def _row(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random(n).astype(np.float32)
    if kind == "quarters":   # plateaus and ties on a 1/4 grid
        return (rng.integers(0, 5, n) / 4).astype(np.float32)
    if kind == "spiky":      # a normalised onset envelope's shape
        x = rng.exponential(size=n) ** 4
        return (x / max(x.max(initial=0.0), 1e-30)).astype(np.float32)
    if kind == "constant":
        return np.full(n, 0.375, np.float32)
    x = rng.random(n).astype(np.float32)
    x[rng.random(n) < 0.02] = np.nan
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_points_equal_numpy_and_jax(n, kind):
    env = _row(kind, n, seed=n * 7 + len(kind))
    for args in WINDOWS:
        before = to.peak_pick.native_calls
        got = to.peak_pick(env, *args)
        assert to.peak_pick.native_calls == before + 1
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, to.peak_pick_ref(env, *args),
                                      err_msg=str(args))
        np.testing.assert_array_equal(got, jo.peak_pick(env, *args),
                                      err_msg=str(args))


def _numpy_means(env, pre_avg, post_avg):
    """Each row's window mean as ``peak_pick_ref`` computes it: a sliding
    view for the untruncated rows, a slice's mean for the edges."""
    n = len(env)
    out = np.empty(n, np.float32)
    lo, hi = pre_avg, n - post_avg
    if hi > lo:
        view = np.lib.stride_tricks.sliding_window_view(
            env, pre_avg + post_avg)
        out[lo:hi] = view[:hi - lo].mean(axis=-1)
    for i in list(range(min(lo, n))) + list(range(max(hi, 0), n)):
        out[i] = env[max(i - pre_avg, 0):min(i + post_avg, n)].mean()
    return out


@pytest.mark.parametrize("pre_avg,post_avg",
                         [(6, 7), (2, 3), (4, 4), (60, 68), (64, 65),
                          (100, 60), (700, 301)])
@pytest.mark.parametrize("kind", ("uniform", "spiky", "nans"))
def test_window_means_bitwise(pre_avg, post_avg, kind):
    lib = to._native()
    for n in (5, 200, 4099):
        env = _row(kind, n, seed=n + pre_avg)
        got = np.empty(n, np.float32)
        lib.afpp_window_means(env.ctypes.data, n, pre_avg, post_avg,
                              got.ctypes.data)
        with np.errstate(invalid="ignore"):
            want = _numpy_means(env, pre_avg, post_avg)
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got.view(np.uint32)[~nan],
                                      want.view(np.uint32)[~nan],
                                      err_msg=f"n={n}")


def test_route_and_counter():
    env = _row("uniform", 500, seed=3)
    args = WINDOWS[0]
    want = to.peak_pick_ref(env, *args)
    before = to.peak_pick.native_calls
    # float64 rows, a float64 delta (numpy then adds the threshold in
    # float64), negative windows: the numpy form
    np.testing.assert_array_equal(
        to.peak_pick(env.astype(np.float64), *args),
        to.peak_pick_ref(env.astype(np.float64), *args))
    np.testing.assert_array_equal(
        to.peak_pick(env, *args[:5], np.float64(args[5])),
        to.peak_pick_ref(env, *args[:5], np.float64(args[5])))
    with pytest.raises(ValueError):
        to.peak_pick(env, -1, 2, 6, 7, 1, 0.07)
    assert to.peak_pick.native_calls == before
    # a float32 view with a stride, a float32 delta, windows past the row
    view = np.repeat(env, 2)[::2]
    np.testing.assert_array_equal(to.peak_pick(view, *args), want)
    np.testing.assert_array_equal(
        to.peak_pick(env, *args[:5], np.float32(args[5])),
        to.peak_pick_ref(env, *args[:5], np.float32(args[5])))
    big = (600, 700, 900, 1000, 10 ** 12, 0.07)
    np.testing.assert_array_equal(to.peak_pick(env, *big),
                                  to.peak_pick_ref(env, *big))
    assert to.peak_pick.native_calls == before + 3


def test_onset_takes_the_native_pass():
    import audioflux_torch as aft
    rng = np.random.default_rng(5)
    spec = np.abs(rng.standard_normal((128, 300))).astype(np.float32)
    onset = aft.Onset(time_length=300, fre_length=128, slide_length=512,
                      device="cpu")
    before = to.peak_pick.native_calls
    points, env, _ = onset.onset(spec)
    assert to.peak_pick.native_calls == before + 1
    np.testing.assert_array_equal(points, to.peak_pick_ref(
        env, onset.pre_max, onset.post_max, onset.pre_avg, onset.post_avg,
        onset.wait, onset.delta))


def test_host_build(tmp_path, monkeypatch):
    path = _build.library_path("libafpp")
    to._native()
    assert path.parent == _build.BUILD_DIR and path.exists()
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(_build.HOST, "libbad", (bad, ["-shared", "-fPIC"]))
    with pytest.raises(OSError, match="g\\+\\+ failed"):
        _build.load("libbad")
    monkeypatch.setitem(_build.HOST, "libnone",
                        (tmp_path / "none.cpp", []))
    with pytest.raises(OSError, match="missing"):
        _build.library_path("libnone")
