"""The port's BFT and Temporal on the CPU (``device="cpu"``) against the
JAX package on the CPU (1e-4 of the peak unless a case says otherwise)
and against the reference C goldens (tests/test_bft.py's and
tests/test_fuzz_goldens.py's tolerances).  ``bft_fused`` is held against
JAX's ``bft_fused`` (its Pallas kernel in interpret mode on the CPU) and
against the exact ``bft``."""

import json

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.types import (SpectralDataType as D,
                                 SpectralFilterBankNormalType as NT,
                                 SpectralFilterBankScaleType as S,
                                 SpectralFilterBankStyleType as ST,
                                 WindowType)
from tests.conftest import assert_close_to_golden

SR = 32000
CPU = {"device": "cpu"}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=1e-4, label=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    peak = max(np.max(np.abs(ref)), 1e-20)
    err = np.max(np.abs(got - ref))
    assert err <= tol * peak, f"{label}: rel err {err / peak:.3e} > {tol}"


def _noise(shape, seed):
    return (0.2 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _pair(**kw):
    return af.BFT(**kw), aft.BFT(**kw, **CPU)


# (label, BFT kwargs): every supported scale, both data types, styles and
# normalizations, a bin range of the LINEAR scale
_CASES = [
    ("linear_power", dict(num=513, radix2_exp=10, data_type=D.POWER)),
    ("linear_sub_mag", dict(num=200, radix2_exp=10, low_fre=500.0,
                            data_type=D.MAG)),
    ("linspace_mag", dict(num=64, radix2_exp=10, scale_type=S.LINSPACE)),
    ("mel_power", dict(num=64, radix2_exp=10, scale_type=S.MEL,
                       data_type=D.POWER)),
    ("bark_mag_area", dict(num=48, radix2_exp=10, scale_type=S.BARK,
                           normal_type=NT.AREA)),
    ("erb_gammatone_power", dict(num=48, radix2_exp=10, scale_type=S.ERB,
                                 style_type=ST.GAMMATONE,
                                 data_type=D.POWER)),
    ("octave_mag", dict(num=60, radix2_exp=11, scale_type=S.OCTAVE)),
    ("log_power_hamm", dict(num=60, radix2_exp=11, scale_type=S.LOG,
                            data_type=D.POWER,
                            window_type=WindowType.HAMM)),
]


@pytest.mark.parametrize("result_type", [0, 1])
@pytest.mark.parametrize("case", _CASES, ids=lambda c: c[0])
def test_bft_matches_jax(case, result_type, signals):
    label, kw = case
    j, t = _pair(samplate=SR, slide_length=256, **kw)
    x = np.stack([signals["chord"][:6000], signals["sine"][:6000]])
    got = t.bft(x, result_type=result_type)
    assert got.dtype == (torch.complex64 if result_type == 0
                         else torch.float32)
    _close(got, j.bft(x, result_type=result_type), 1e-4, label)
    assert np.array_equal(t.get_fre_band_arr(), j.get_fre_band_arr())
    assert t.cal_time_length(6000) == j.cal_time_length(6000)


@pytest.mark.parametrize("data_type", [D.POWER, D.MAG])
def test_bft_norm_value(data_type, signals):
    x = signals["sine"][:8000]
    for scale in (S.LINEAR, S.MEL):
        j, t = _pair(num=64, radix2_exp=10, samplate=SR, scale_type=scale,
                     data_type=data_type)
        for plan in (j, t):
            plan.set_data_norm_value(0.5)
        _close(t.bft(x, result_type=1), j.bft(x, result_type=1), 1e-4,
               f"{scale.name}/{data_type.name}")


@pytest.mark.parametrize("key,kw,tol", [
    ("bft_mel_mag", dict(num=128, scale_type=S.MEL, data_type=D.MAG), 5e-5),
    ("bft_lin_cpx", dict(num=1025, scale_type=S.LINEAR, data_type=D.POWER),
     5e-5),
    ("bft_mel_rea", dict(num=128, scale_type=S.MEL, data_type=D.POWER,
                         is_reassign=True), 2e-4),
])
def test_bft_goldens(key, kw, tol, goldens, signals):
    g = goldens("bft")
    t = aft.BFT(radix2_exp=11, samplate=SR, slide_length=512, **kw, **CPU)
    x = signals["chord"][:16000]
    if key == "bft_lin_cpx":
        C = _np(t.bft(x, result_type=0))
        assert_close_to_golden(C.real, g[f"{key}_re"], tol, f"{key}_re")
        assert_close_to_golden(C.imag, g[f"{key}_im"], tol, f"{key}_im")
    else:
        out = np.abs(_np(t.bft(x, result_type=1)))
        assert_close_to_golden(out, g[key], tol, key)


@pytest.mark.parametrize("i", range(36))
def test_fuzz_bft_golden(goldens, signals, i):
    g = goldens("fuzz_bft")
    p = json.loads(str(g[f"c{i}_params"]))
    t = aft.BFT(num=p["num"], radix2_exp=p["r2e"], samplate=SR,
                low_fre=p["low"], high_fre=p["high"], bin_per_octave=p["bpo"],
                window_type=WindowType(p["window"]), slide_length=p["slide"],
                scale_type=S(p["scale"]), style_type=ST(p["style"]),
                normal_type=NT(p["norm"]), data_type=D(p["data"]), **CPU)
    out = np.abs(_np(t.bft(signals["sine"][:8000], result_type=1)))
    assert_close_to_golden(out, g[f"c{i}_arr"], 2e-4, f"fuzz_bft[{i}] {p}")
    np.testing.assert_allclose(t.get_fre_band_arr(), g[f"c{i}_fre"],
                               rtol=2e-5, atol=2e-3)


# (label, BFT kwargs, frames, ragged tail, cc_num): the fused kernel's
# plain version against JAX's fused kernel (interpret mode) and against
# the exact bft; LINEAR runs the exact 0/1 selection bank
_FUSED = [
    ("mel64_2048", dict(num=64, radix2_exp=11, slide_length=512,
                        scale_type=S.MEL), 11, 0, 5),
    ("linear513_1024_ragged_cc0", dict(num=513, radix2_exp=10,
                                       slide_length=256), 14, 128, 0),
]


@pytest.mark.parametrize("case", _FUSED, ids=lambda c: c[0])
def test_bft_fused(case):
    label, kw, frames, tail, cc_num = case
    j, t = _pair(samplate=SR, data_type=D.POWER, **kw)
    n = (frames - 1) * kw["slide_length"] + (1 << kw["radix2_exp"]) + tail
    x = _noise((2, n), frames)
    spec, cc = t.bft_fused(x, cc_num=cc_num, tile=8)
    exact = t.bft(x, result_type=1)
    assert spec.shape == exact.shape == (2, kw["num"], frames)
    assert cc.shape == (2, cc_num, frames)
    _close(spec, exact, 1e-4, f"{label} vs exact")
    _close(spec, j.bft(x, result_type=1), 1e-4, f"{label} vs JAX exact")
    spec_j, cc_j = j.bft_fused(x, cc_num=cc_num, tile=8)
    _close(spec, spec_j, 1e-4, f"{label} vs JAX fused")
    assert np.asarray(cc_j).shape == cc.shape
    if cc_num:
        _close(cc, cc_j, 1e-4, f"{label} cc vs JAX fused")
    assert list(t._fused_cache) == [max(cc_num, 1)]


def test_bft_fused_rejections():
    for kw in (dict(data_type=D.MAG), dict(is_reassign=True,
                                           data_type=D.POWER)):
        t = aft.BFT(num=64, radix2_exp=10, samplate=SR, **kw, **CPU)
        with pytest.raises(ValueError):
            t.bft_fused(np.zeros(4096, np.float32))
    t = aft.BFT(num=64, radix2_exp=10, samplate=SR, data_type=D.POWER, **CPU)
    t.set_data_norm_value(2.0)
    with pytest.raises(ValueError):
        t.bft_fused(np.zeros(4096, np.float32))
    with pytest.raises(ValueError):
        aft.BFT(num=64, scale_type=S.CHROMA, **CPU)
    with pytest.raises(ValueError):
        aft.BFT(num=600, radix2_exp=10, **CPU)


@pytest.mark.parametrize("window", [WindowType.HANN, WindowType.HAMM,
                                    WindowType.RECT])
def test_temporal(window, signals):
    x = np.stack([signals["sine"][:9000], signals["chirp"][:9000]])
    j = af.Temporal(frame_length=1024, slide_length=256, window_type=window)
    t = aft.Temporal(frame_length=1024, slide_length=256, window_type=window,
                     **CPU)
    for a, b, what in zip(t.temporal(x), j.temporal(x),
                          ("energy", "rms", "zcr")):
        _close(a, b, 1e-5, what)
    _close(t.ezr(2.0), j.ezr(2.0), 1e-5, "ezr")
    dic_t = t.temporal(x, has_energy=True, has_zcr=True, has_m=True)
    dic_j = j.temporal(x, has_energy=True, has_zcr=True, has_m=True)
    assert sorted(dic_t) == sorted(dic_j) == ["energy_arr", "m_arr",
                                              "zcr_arr"]
    for k in dic_t:
        _close(dic_t[k], dic_j[k], 1e-5, k)
    _close(t.get_data()[3], j.get_data()[3], 1e-6, "frames")
    assert t.cal_time_length(9000) == j.cal_time_length(9000)
    with pytest.raises(RuntimeError):
        aft.Temporal(**CPU).ezr()


def test_bft_temporal_side_data(signals):
    x = signals["chord"][:16000]
    kw = dict(num=128, radix2_exp=11, samplate=SR, slide_length=512,
              scale_type=S.MEL, is_temporal=True)
    j, t = _pair(**kw)
    _close(t.bft(x, result_type=1), j.bft(x, result_type=1), 1e-4, "bft")
    for a, b in zip(t.get_temporal_data(), j.get_temporal_data()):
        _close(a, b, 1e-5, "temporal")
    with pytest.raises(RuntimeError):
        aft.BFT(num=64, **CPU).get_temporal_data()


def test_bft_coordinates():
    j, t = _pair(num=128, radix2_exp=11, samplate=SR, slide_length=512,
                 scale_type=S.MEL)
    assert np.array_equal(t.y_coords(), j.y_coords())
    np.testing.assert_allclose(t.x_coords(16000), j.x_coords(16000))
    assert np.array_equal(t.get_bin_band_arr(), j.get_bin_band_arr())
