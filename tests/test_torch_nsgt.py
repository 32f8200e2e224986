"""The port's NSGT on the CPU (``device="cpu"``): its constants equal to
the JAX package's (band lengths, windows, offsets, expansion index, band
frequencies), its output against the JAX package on the CPU on the same
seeded inputs (2e-6 of the peak), against the reference C goldens at
tests/test_nsgt.py's and tests/test_fuzz_goldens.py's tolerances, and with
``load_reference_constants`` installing a JAX plan's constants."""

import json

import jax
import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.types import (SpectralFilterBankNormalType as NT,
                                 SpectralFilterBankScaleType as S,
                                 SpectralFilterBankStyleType as ST)
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


def _clips(n, k=2, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 32000
    tone = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 3e3 * t)
    return (tone + 0.1 * rng.standard_normal((k, n))).astype(np.float32)


_CASES = [
    dict(),
    dict(num=64, scale_type=S.MEL,
         nsgt_filter_bank_type=aft.NSGTFilterBankType.STANDARD),
    dict(num=40, radix2_exp=11, scale_type=S.LINEAR, style_type=ST.HANN),
    dict(num=48, radix2_exp=11, scale_type=S.BARK, min_len=9,
         normal_type=NT.NONE, style_type=ST.RECT),
    dict(num=30, radix2_exp=11, scale_type=S.LOG, style_type=ST.GAMMATONE,
         nsgt_filter_bank_type=aft.NSGTFilterBankType.STANDARD),
    dict(num=24, radix2_exp=12, scale_type=S.OCTAVE, bin_per_octave=6,
         low_fre=110.0),
]


@pytest.mark.parametrize("kw", _CASES, ids=range(len(_CASES)))
def test_nsgt_vs_jax(kw):
    t, j = aft.NSGT(**kw, **CPU), af.NSGT(**kw)
    assert np.array_equal(t.get_time_length_arr(), j.get_time_length_arr())
    assert np.array_equal(t.get_fre_band_arr(), j.get_fre_band_arr())
    assert np.array_equal(t.get_bin_band_arr(), j.get_bin_band_arr())
    assert t._offsets == j._offsets
    assert np.array_equal(t._expand, j._expand)
    for a, b in zip(t._windows, j._windows):
        assert np.array_equal(a, b)
    x = _clips(t.fft_length)
    got = t.nsgt(x)
    assert got.dtype == torch.complex64
    _close(got, j.nsgt(x), label=f"nsgt {kw}")
    _close(t.nsgt(x[0]), got[0], label="one clip vs the batch")


def test_nsgt_min_length_and_coords():
    t, j = aft.NSGT(num=32, radix2_exp=11, **CPU), af.NSGT(num=32,
                                                         radix2_exp=11)
    for p in (t, j):
        p.set_min_length(25)
    assert t.get_max_time_length() == j.get_max_time_length()
    assert t.get_total_time_length() == j.get_total_time_length()
    x = _clips(2048)
    _close(t.nsgt(x), j.nsgt(x), label="min_length 25")
    np.testing.assert_allclose(t.x_coords(4096), j.x_coords(4096))
    np.testing.assert_allclose(t.x_coords(), j.x_coords())
    with pytest.raises(ValueError):
        t.set_min_length(0)
    with pytest.raises(ValueError, match="data length"):
        t.nsgt(x[:, :1000])


def test_nsgt_goldens(goldens, signals):
    g = goldens("nsgt")
    obj = aft.NSGT(num=84, radix2_exp=12, samplate=32000,
                   scale_type=S.OCTAVE, **CPU)
    assert np.array_equal(obj.get_time_length_arr(), g["oct_lens"])
    np.testing.assert_allclose(obj.get_fre_band_arr(), g["oct_fre"],
                               rtol=1e-5, atol=1e-2)
    C = _np(obj.nsgt(signals["chord"][:4096]))
    assert_close_to_golden(C.real, g["oct_re"], 5e-5, "oct_re")
    assert_close_to_golden(C.imag, g["oct_im"], 5e-5, "oct_im")
    obj = aft.NSGT(num=64, radix2_exp=12, samplate=32000, scale_type=S.MEL,
                   nsgt_filter_bank_type=aft.NSGTFilterBankType.STANDARD,
                   **CPU)
    assert np.array_equal(obj.get_time_length_arr(), g["mel_std_lens"])
    C = _np(obj.nsgt(signals["chord"][:4096]))
    assert_close_to_golden(C.real, g["mel_std_re"], 5e-5, "mel_std_re")
    assert_close_to_golden(C.imag, g["mel_std_im"], 5e-5, "mel_std_im")


@pytest.mark.parametrize("i", range(12))      # test_fuzz_goldens N_NSGT_CASES
def test_fuzz_nsgt_goldens(goldens, signals, i):
    g = goldens("fuzz_nsgt")
    p = json.loads(str(g[f"c{i}_params"]))
    x = signals["sine"][:1 << p["r2e"]]
    obj = aft.NSGT(num=p["num"], radix2_exp=p["r2e"], samplate=32000,
                   low_fre=p["low"], high_fre=p["high"],
                   bin_per_octave=p["bpo"], min_len=p["min_len"],
                   nsgt_filter_bank_type=aft.NSGTFilterBankType(p["bank"]),
                   scale_type=S(p["scale"]), style_type=ST(p["style"]),
                   normal_type=NT(p["norm"]), **CPU)
    assert_close_to_golden(np.abs(_np(obj.nsgt(x))), g[f"c{i}_mag"], 2e-4,
                           f"fuzz_nsgt[{i}] {p}")
    np.testing.assert_array_equal(
        np.asarray(obj.get_time_length_arr(), np.int64), g[f"c{i}_lens"])
    np.testing.assert_allclose(np.asarray(obj.get_fre_band_arr(), np.float32),
                               g[f"c{i}_fre"], rtol=2e-5, atol=2e-3)


def test_nsgt_load_reference_constants():
    """A JAX plan's windows (scaled), offsets and expansion index installed
    into a port plan: both compute the same."""
    kw = dict(num=40, radix2_exp=11, scale_type=S.MEL)
    j = af.NSGT(**kw)
    j._windows = [(w * (1.0 + 0.01 * i)).astype(np.float32)
                  for i, w in enumerate(j._windows)]
    j._expand = np.maximum(j._expand - 1, 0)
    j._nsgt_run = jax.jit(j._nsgt_impl)     # trace anew with the new arrays
    t = aft.NSGT(**kw, **CPU)
    aft.load_reference_constants(t, windows=j._windows, offsets=j._offsets,
                                 expand=j._expand)
    x = _clips(2048)
    _close(t.nsgt(x), j.nsgt(x), label="installed constants")
    with pytest.raises(ValueError, match="expand"):
        aft.load_reference_constants(t, expand=j._expand[:, 1:])
    with pytest.raises(ValueError, match="windows"):
        aft.load_reference_constants(t, windows=j._windows[1:])
