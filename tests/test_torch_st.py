"""The port's ST, ``cst`` and FST on the CPU (``device="cpu"``), and the
fuzz_features golden group through the port; against
the JAX package on the CPU on the same seeded inputs (2e-6 of the peak:
both run one float32 FFT and one float32 inverse of the same windowed
rows), against the reference C goldens at tests/test_st.py's and
tests/test_fuzz_goldens.py's tolerances (5e-5 of the peak), and with
``load_reference_constants`` installing a JAX plan's windows."""

import json

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}
TOL = 2e-6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL, label=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    peak = max(np.max(np.abs(ref)), 1e-20)
    err = np.max(np.abs(got - ref))
    assert err <= tol * peak, f"{label}: rel err {err / peak:.3e} > {tol}"


def _clips(n, k=3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 32000
    tone = 0.4 * np.sin(2 * np.pi * 523.25 * t)
    return (tone + 0.1 * rng.standard_normal((k, n))).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(radix2_exp=10),
    dict(radix2_exp=10, min_index=0, max_index=100),     # the mean row
    dict(radix2_exp=11, min_index=10, max_index=300, factor=2.0, norm=0.8),
    dict(radix2_exp=10, min_index=600, max_index=100),   # reset to 0..L/2
], ids=["default", "mean-row", "params", "bad-range"])
def test_st_vs_jax(kw):
    x = _clips(1 << kw["radix2_exp"])
    got = aft.ST(**kw, **CPU).st(x)
    assert got.dtype == torch.complex64
    _close(got, af.ST(**kw).st(x), label=f"st {kw}")


def test_st_bins_and_values_vs_jax():
    x = _clips(1024, k=2)
    t, j = aft.ST(radix2_exp=10, **CPU), af.ST(radix2_exp=10)
    for p in (t, j):
        p.use_bin_arr([0, 3, 17, 200, 512])
        p.set_value(1.5, 0.9)
    _close(t.st(x), j.st(x), label="use_bin_arr + set_value")
    np.testing.assert_allclose(t.y_coords(), j.y_coords())
    np.testing.assert_allclose(t.get_fre_band_arr(), j.get_fre_band_arr())


@pytest.mark.parametrize("n", [2048, 2048 + 700, 3 * 512])
def test_cst_vs_jax(n):
    x = _clips(n, k=2)
    _close(aft.ST(radix2_exp=10, **CPU).cst(x), af.ST(radix2_exp=10).cst(x),
           label=f"cst n={n}")


def test_cst_too_short():
    with pytest.raises(ValueError, match="too short"):
        aft.ST(radix2_exp=10, **CPU).cst(np.zeros(1000, np.float32))


def test_st_goldens(goldens, signals):
    g = goldens("st")
    x = signals["chord"][:1024]
    C = _np(aft.ST(radix2_exp=10, min_index=1, max_index=511, **CPU).st(x))
    assert_close_to_golden(C.real, g["st_re"], 5e-5, "st_re")
    assert_close_to_golden(C.imag, g["st_im"], 5e-5, "st_im")
    C = _np(aft.ST(radix2_exp=10, min_index=10, max_index=100, factor=2.0,
                   norm=0.8, **CPU).st(x))
    assert_close_to_golden(C.real, g["st2_re"], 5e-5, "st2_re")
    assert_close_to_golden(C.imag, g["st2_im"], 5e-5, "st2_im")


def test_fst_goldens(goldens, signals):
    g = goldens("st")
    x = signals["chord"][:1024]
    fst = aft.FST(radix2_exp=10, **CPU)
    C = _np(fst.fst(x, 1, 511))
    assert_close_to_golden(C.real, g["fst_re"], 5e-5, "fst_re")
    assert_close_to_golden(C.imag, g["fst_im"], 5e-5, "fst_im")
    C2 = _np(fst.fst(x, 5, 100))
    assert_close_to_golden(C2.real, g["fst2_re"], 5e-5, "fst2_re")


_FEATURE_CASES = 14     # tests/test_fuzz_goldens.py N_FEAT_CASES


@pytest.mark.parametrize("i", range(_FEATURE_CASES))
def test_fuzz_features_goldens(goldens, signals, i):
    """Every case of the fuzz_features group (xxcc, xxcc_std, deconv,
    temporal, cepstrogram, st, fst) through the port, at
    tests/test_fuzz_goldens.py's tolerances."""
    g = goldens("fuzz_features")
    p = json.loads(str(g[f"c{i}_params"]))
    kind = p["kind"]
    x = signals["chord"]
    tag = f"fuzz_features[{i}] {p}"
    if kind == "xxcc":
        out = aft.XXCC(num=p["num"], **CPU).xxcc(
            g[f"c{i}_in_spec"], cc_num=p["cc"],
            rectify_type=getattr(aft.CepstralRectifyType, p["rectify"]))
        atol = 2e-3 if p["rectify"] == "CUBIC_ROOT" else 2e-4
        np.testing.assert_allclose(_np(out), g[f"c{i}_arr"], atol=atol,
                                   err_msg=tag)
    elif kind == "xxcc_std":
        outs = aft.XXCC(num=p["num"], **CPU).xxcc_standard(
            g[f"c{i}_in_spec"], g[f"c{i}_in_energy"], cc_num=p["cc"],
            delta_window_length=p["dwl"],
            energy_type=aft.CepstralEnergyType.REPLACE)
        for out, key in zip(outs, ("coe", "d1", "d2")):
            np.testing.assert_allclose(_np(out), g[f"c{i}_{key}"],
                                       atol=2e-4, err_msg=tag)
    elif kind == "deconv":
        timbre, pitch = aft.Deconv(num=p["num"], **CPU).deconv(
            g[f"c{i}_in_spec"])
        assert_close_to_golden(_np(timbre), g[f"c{i}_timbre"], 5e-5, tag)
        assert_close_to_golden(_np(pitch), g[f"c{i}_pitch"], 5e-4, tag)
    elif kind == "temporal":
        res = aft.Temporal(frame_length=p["frame"], slide_length=p["slide"],
                           window_type=getattr(aft.WindowType, p["window"]),
                           **CPU).temporal(x, has_energy=True, has_rms=True,
                                           has_zcr=True, has_m=True)
        assert_close_to_golden(_np(res["energy_arr"]), g[f"c{i}_energy"],
                               5e-5, tag)
        assert_close_to_golden(_np(res["rms_arr"]), g[f"c{i}_rms"], 5e-5,
                               tag)
        np.testing.assert_allclose(_np(res["zcr_arr"]), g[f"c{i}_zcr"],
                                   atol=1e-6, err_msg=tag)
        assert_close_to_golden(_np(res["m_arr"]), g[f"c{i}_m"], 5e-6, tag)
    elif kind == "cepstrogram":
        cp = aft.Cepstrogram(radix2_exp=p["r2e"], samplate=32000,
                             window_type=getattr(aft.WindowType, p["window"]),
                             slide_length=p["slide"], **CPU)
        c1, c2, c3 = (_np(c) for c in cp.cepstrogram(signals["sine"],
                                                      cep_num=p["cep"]))
        assert_close_to_golden(c1, g[f"c{i}_ceps"], 5e-5, tag)
        assert_close_to_golden(c2, g[f"c{i}_env"], 5e-5, tag)
        assert_close_to_golden(c3, g[f"c{i}_det"], 2e-3, tag)
    elif kind == "st":
        C = _np(aft.ST(radix2_exp=p["r2e"], min_index=p["mn"],
                       max_index=p["mx"], factor=p["factor"], norm=p["norm"],
                       **CPU).st(x[:1 << p["r2e"]]))
        assert_close_to_golden(C.real, g[f"c{i}_re"], 5e-5, tag)
        assert_close_to_golden(C.imag, g[f"c{i}_im"], 5e-5, tag)
    else:
        assert kind == "fst", tag
        C = _np(aft.FST(radix2_exp=p["r2e"], samplate=32000, **CPU)
                .fst(x[:1 << p["r2e"]], p["mn"], p["mx"]))
        assert_close_to_golden(C.real, g[f"c{i}_re"], 5e-5, tag)
        assert_close_to_golden(C.imag, g[f"c{i}_im"], 5e-5, tag)


@pytest.mark.parametrize("r2e,rng_", [(10, None), (10, (5, 100)),
                                      (11, (0, 1024)), (12, None),
                                      (10, (300, 20))])
def test_fst_vs_jax(r2e, rng_):
    x = _clips(1 << r2e, k=2)
    t, j = aft.FST(radix2_exp=r2e, **CPU), af.FST(radix2_exp=r2e)
    args = () if rng_ is None else rng_
    _close(t.fst(x, *args), j.fst(x, *args), label=f"fst {r2e} {rng_}")
    np.testing.assert_allclose(t.get_fre_band_arr(), j.get_fre_band_arr())


def test_fst_ctor_range():
    x = _clips(1024, k=1)[0]
    t = aft.FST(radix2_exp=10, min_index=3, max_index=40, **CPU)
    j = af.FST(radix2_exp=10, min_index=3, max_index=40)
    out = t.fst(x)
    assert tuple(out.shape) == (38, 1024)
    _close(out, j.fst(x), label="ctor range")


def test_st_load_reference_constants():
    """A JAX plan's windows, perturbed so that the port's own would not
    match, installed into the port plan: both compute the same."""
    x = _clips(1024, k=2)
    j = af.ST(radix2_exp=10, min_index=2, max_index=300)
    j._windows = (j._windows * np.linspace(0.5, 1.5, 1024)).astype(np.float32)
    t = aft.ST(radix2_exp=10, min_index=2, max_index=300, **CPU)
    aft.load_reference_constants(t, windows=j._windows)
    _close(t.st(x), j.st(x), label="installed windows")
    with pytest.raises(ValueError, match="windows"):
        aft.load_reference_constants(t, windows=j._windows[1:])
