"""The port's DWT, WPT and SWT on the CPU (``device="cpu"``): its own
coefficient table equal, array for array, to the JAX package's; its
outputs against the JAX package on the CPU on the same seeded inputs
(2e-6 of the peak: the same float32 products, summed in another order),
against the reference C goldens at tests/test_dwt.py's and
tests/test_fuzz_goldens.py's tolerance (5e-5 of the peak), and with
``load_reference_constants`` installing a JAX plan's taps."""

import json
import os

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.types import WaveletDiscreteType as W
from audioflux_torch.filterbank import dwt as tdwt
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}
TOL = 2e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL, label=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    peak = max(np.max(np.abs(ref)), 1e-20)
    err = np.max(np.abs(got - ref))
    assert err <= tol * peak, f"{label}: rel err {err / peak:.3e} > {tol}"


def _clips(n, k=2, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, n)).astype(np.float32)


def test_coefficient_table_is_the_jax_packages():
    """The port reads its own copy; it holds the same arrays."""
    ours = os.path.join(REPO, "audioflux_torch", "filterbank", "data",
                        "dwt_coef.npz")
    theirs = os.path.join(REPO, "audioflux_tpu", "filterbank", "data",
                          "dwt_coef.npz")
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert max(len(tdwt._load()[k]) for k in tdwt._load()) == 102


@pytest.mark.parametrize("r2e,num", [(3, 1), (3, 2), (8, 4), (10, 9)])
def test_display_index_tables_equal_jax(r2e, num):
    """The dyadic (DWT) and leaf (WPT) display gathers, built in closed
    form, equal the JAX package's loops."""
    assert np.array_equal(aft.DWT(num=num, radix2_exp=r2e, **CPU)._rows,
                          af.DWT(num=num, radix2_exp=r2e)._rows)
    assert np.array_equal(aft.WPT(num=num, radix2_exp=r2e, **CPU)._rows,
                          af.WPT(num=num, radix2_exp=r2e)._rows)


_WAVELETS = [(W.SYM, 4, 0), (W.DB, 4, 0), (W.COIF, 3, 0), (W.HAAR, 0, 0),
             (W.BIOR, 3, 5), (W.FK, 8, 0), (W.DMEY, 0, 0), (W.DB, 20, 0)]


@pytest.mark.parametrize("wt,t1,t2", _WAVELETS)
def test_dwt_wpt_swt_vs_jax(wt, t1, t2):
    """Each family at a depth that takes the periodic pad's modulo route
    (a filter longer than the level's signal) for the long filters."""
    kw = dict(wavelet_type=wt, t1=t1, t2=t2)
    x = _clips(1024)
    t, j = aft.DWT(radix2_exp=10, **kw, **CPU), af.DWT(radix2_exp=10, **kw)
    for a, b, what in zip(t.dwt(x), j.dwt(x), ("coef", "m")):
        _close(a, b, label=f"dwt {what} {wt.name}{t1}")
    np.testing.assert_array_equal(t.get_fre_band_arr(), j.get_fre_band_arr())
    t, j = (aft.WPT(num=6, radix2_exp=10, **kw, **CPU),
            af.WPT(num=6, radix2_exp=10, **kw))
    for a, b, what in zip(t.wpt(x), j.wpt(x), ("coef", "m")):
        _close(a, b, label=f"wpt {what} {wt.name}{t1}")
    t, j = (aft.SWT(num=3, fft_length=512, **kw, **CPU),
            af.SWT(num=3, fft_length=512, **kw))
    for a, b, what in zip(t.swt(x[:, :512]), j.swt(x[:, :512]), ("a", "d")):
        _close(a, b, label=f"swt {what} {wt.name}{t1}")


def test_wpt_full_tree_and_batch_shapes():
    """The default depth (radix2_exp - 1: leaves of two samples) and a
    leading batch of two axes."""
    x = _clips(256, k=6).reshape(2, 3, 256)
    t, j = aft.WPT(radix2_exp=8, **CPU), af.WPT(radix2_exp=8)
    coef, m = t.wpt(x)
    assert tuple(m.shape) == (2, 3, 128, 256)
    for a, b, what in zip((coef, m), j.wpt(x), ("coef", "m")):
        _close(a, b, label=f"wpt full tree {what}")
    _close(t.wpt(x[1, 2])[0], coef[1, 2], label="one clip vs the batch")


@pytest.mark.parametrize("name,wt,t1,t2", [
    ("sym4", W.SYM, 4, 0), ("db4", W.DB, 4, 0), ("coif3", W.COIF, 3, 0),
    ("haar", W.HAAR, 0, 0), ("bior3_5", W.BIOR, 3, 5), ("fk8", W.FK, 8, 0),
    ("dmey", W.DMEY, 0, 0)])
def test_dwt_goldens(goldens, signals, name, wt, t1, t2):
    g = goldens("dwt")
    x = signals["chord"][:1024]
    coef, m = aft.DWT(num=5, radix2_exp=10, samplate=32000, wavelet_type=wt,
                      t1=t1, t2=t2, **CPU).dwt(x)
    assert_close_to_golden(_np(coef), g[f"dwt_{name}_coef"], 5e-5, name)
    assert_close_to_golden(_np(m), g[f"dwt_{name}_m"], 5e-5, name)


def test_wpt_swt_goldens(goldens, signals):
    g = goldens("dwt")
    x = signals["chord"][:1024]
    coef, m = aft.WPT(num=4, radix2_exp=10, samplate=32000,
                      wavelet_type=W.SYM, t1=4, **CPU).wpt(x)
    assert_close_to_golden(_np(coef), g["wpt_coef"], 5e-5, "wpt_coef")
    assert_close_to_golden(_np(m), g["wpt_m"], 5e-5, "wpt_m")
    a, d = aft.SWT(num=4, fft_length=1024, wavelet_type=W.DB, t1=4,
                   **CPU).swt(x)
    assert_close_to_golden(_np(a), g["swt_a"], 5e-5, "swt_a")
    assert_close_to_golden(_np(d), g["swt_d"], 5e-5, "swt_d")


@pytest.mark.parametrize("i", range(51))      # test_fuzz_goldens N_DWT_CASES
def test_dwt_every_wavelet_golden(goldens, signals, i):
    g = goldens("fuzz_dwt")
    wt, t1, t2, name = str(g[f"c{i}_params"]).split(",")
    coef, m = aft.DWT(num=5, radix2_exp=10, samplate=32000,
                      wavelet_type=W(int(wt)), t1=int(t1), t2=int(t2),
                      **CPU).dwt(signals["sine"][:1024])
    assert_close_to_golden(_np(coef), g[f"c{i}_coef"], 5e-5, f"{name} coef")
    assert_close_to_golden(_np(m), g[f"c{i}_m"], 5e-5, f"{name} m")


@pytest.mark.parametrize("i", range(12))      # N_WPT_SWT_CASES
def test_fuzz_wpt_swt_goldens(goldens, signals, i):
    g = goldens("fuzz_wpt")
    kind, num, sz, wt, t1, t2, name = str(g[f"c{i}_params"]).split(",")
    num, sz, wt, t1, t2 = int(num), int(sz), int(wt), int(t1), int(t2)
    if kind == "wpt":
        coef, m = aft.WPT(num=num, radix2_exp=sz, wavelet_type=W(wt), t1=t1,
                          t2=t2, **CPU).wpt(signals["sine"][:1 << sz])
        assert_close_to_golden(_np(coef), g[f"c{i}_coef"], 5e-5, name)
        assert_close_to_golden(_np(m), g[f"c{i}_m"], 5e-5, name)
    else:
        a, d = aft.SWT(num=num, fft_length=sz, wavelet_type=W(wt), t1=t1,
                       t2=t2, **CPU).swt(signals["sine"][:sz])
        assert_close_to_golden(_np(a), g[f"c{i}_a"], 5e-5, name)
        assert_close_to_golden(_np(d), g[f"c{i}_d"], 5e-5, name)


def test_dwt_argument_checks():
    with pytest.raises(ValueError):
        aft.DWT(num=10, radix2_exp=10, **CPU)
    with pytest.raises(ValueError):
        aft.SWT(num=4, fft_length=1000, **CPU)
    with pytest.raises(ValueError, match="data length"):
        aft.DWT(radix2_exp=10, **CPU).dwt(np.zeros(1000, np.float32))
    with pytest.raises(ValueError, match="unsupported"):
        aft.DWT(radix2_exp=10, wavelet_type=W.DB, t1=99, **CPU)


def test_dwt_load_reference_constants():
    """A JAX plan's taps (altered) installed into port plans."""
    x = _clips(1024)
    j = af.DWT(num=4, radix2_exp=10)
    j.lo_d = (j.lo_d * 1.5).astype(np.float32)
    j.hi_d = j.hi_d[::-1].copy()
    for t, run, jrun in (
            (aft.DWT(num=4, radix2_exp=10, **CPU), "dwt",
             lambda: af.transforms.dwt.DWT._dwt_impl(j, x)),
            (aft.WPT(num=4, radix2_exp=10, **CPU), "wpt",
             lambda: af.transforms.dwt.WPT._wpt_impl(
                 _jwpt(j), x))):
        aft.load_reference_constants(t, lo_d=j.lo_d, hi_d=j.hi_d)
        for a, b in zip(getattr(t, run)(x), jrun()):
            _close(a, b, label=f"installed taps {run}")
    with pytest.raises(ValueError, match="lo_d"):
        aft.load_reference_constants(t, lo_d=j.lo_d[1:], hi_d=j.hi_d)


def _jwpt(dwt_plan):
    """A JAX WPT plan carrying ``dwt_plan``'s taps."""
    w = af.WPT(num=4, radix2_exp=10)
    w.lo_d, w.hi_d = dwt_plan.lo_d, dwt_plan.hi_d
    return w
