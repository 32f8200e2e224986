"""The port's CQT slice on the CPU (``device="cpu"``): ``CQT``, ``VQT``,
``SimpleCQT`` and their postprocessing, the polyphase resampler, the new
one-shots, ``load_reference_constants`` for BFT, Reassign, CQT and
Spectral, and the device policy of every new plan and one-shot; against
the JAX package on the CPU (1e-4 of the peak unless a case says otherwise)
and against the reference C goldens (tests/test_cqt.py's and
tests/test_fuzz_goldens.py's tolerances)."""

import importlib
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.types import (ChromaDataNormalType,
                                 ResampleQualityType as Q,
                                 SpectralDataType as D,
                                 SpectralFilterBankNormalType as NT,
                                 SpectralFilterBankScaleType as S,
                                 WindowType)
from tests.conftest import assert_close_to_golden
from tests.test_torch_reassign import assert_flips_and_mass

SR = 32000
CPU = {"device": "cpu"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules (both packages' dsp export a function of the same name)
jrs = importlib.import_module("audioflux_tpu.dsp.resample")
trs = importlib.import_module("audioflux_torch.dsp.resample")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=1e-4, label=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    peak = max(np.max(np.abs(ref)), 1e-20)
    err = np.max(np.abs(got - ref))
    assert err <= tol * peak, f"{label}: rel err {err / peak:.3e} > {tol}"


@pytest.fixture(scope="module")
def cqt_pair(goldens, signals):
    g = goldens("cqt")
    t = aft.CQT(num=84, samplate=SR, **CPU)
    return t, t.cqt(signals["chord"]), g


def test_cqt_golden_and_jax(cqt_pair, signals):
    t, C, g = cqt_pair
    assert C.dtype == torch.complex64
    assert t.fft_length == g["cqt_fft_length"][0]
    np.testing.assert_allclose(t.get_fre_band_arr(), g["cqt_fre"], atol=1e-3)
    C = _np(C)
    assert_close_to_golden(C.real, g["cqt_re"], 5e-5, "cqt_re")
    assert_close_to_golden(C.imag, g["cqt_im"], 5e-5, "cqt_im")
    _close(C, af.CQT(num=84, samplate=SR).cqt(signals["chord"]), 1e-4,
           "vs JAX")


def test_cqt_postprocessing_goldens(cqt_pair):
    t, C, g = cqt_pair
    assert_close_to_golden(_np(t.chroma(C)), g["cqt_chroma"], 2e-4,
                           "cqt_chroma")
    # fed the golden CQT, as tests/test_cqt.py does: log10 of noise-floor
    # bins would amplify 5e-6-level differences
    ref_C = np.abs(g["cqt_re"] + 1j * g["cqt_im"])
    np.testing.assert_allclose(_np(t.cqcc(ref_C, cc_num=13)), g["cqt_cqcc"],
                               atol=2e-3)
    mag = C.abs()
    assert_close_to_golden(_np(t.cqhc(mag ** 2, hc_num=13)), g["cqt_cqhc"],
                           2e-4, "cqt_cqhc")
    timbre, pitch = t.deconv(mag)
    assert_close_to_golden(_np(timbre), g["cqt_dec_t"], 2e-4, "cqt_dec_t")
    assert_close_to_golden(_np(pitch), g["cqt_dec_p"], 2e-3, "cqt_dec_p")


def test_cqt_postprocessing_vs_jax(cqt_pair):
    t, C, _ = cqt_pair
    j = af.CQT(num=84, samplate=SR)
    Cn = _np(C)
    mag = np.abs(Cn)
    for dt in D:
        for nt in ChromaDataNormalType:
            _close(t.chroma(Cn, 12, dt, nt), j.chroma(Cn, 12, dt, nt), 1e-4,
                   f"chroma {dt.name}/{nt.name}")
    _close(t.chroma(mag, 4), j.chroma(mag, 4), 1e-4, "chroma of |C|, 4")
    _close(t.cqcc(mag, 20), j.cqcc(mag, 20), 1e-4, "cqcc")
    _close(t.cqhc(mag, 8), j.cqhc(mag, 8), 1e-4, "cqhc")
    for a, b in zip(t.deconv(mag), j.deconv(mag)):
        _close(a, b, 1e-4, "deconv")


# (label, class, kwargs, signal length): beta > 0 builds per-octave
# kernels; num=24 from C1 needs a 16384-point top-octave transform, the
# FFT kernel tier's size on the card (its plain version here)
_PLANS = [
    ("vqt", "VQT", dict(num=84, beta=0.5), 16000),
    ("cqt_beta_bandwidth", "CQT", dict(num=48, beta=0.3,
                                       low_fre=65.41,
                                       normal_type=NT.BAND_WIDTH), 16000),
    ("cqt_bpo24_hamm_noscale", "CQT", dict(num=96, bin_per_octave=24,
                                           window_type=WindowType.HAMM,
                                           is_scale=False,
                                           slide_length=700), 12000),
    ("cqt_num24_fft16384", "CQT", dict(num=24), 20000),
    ("simple", "SimpleCQT", dict(num=84), 16000),
]


@pytest.mark.parametrize("case", _PLANS, ids=lambda c: c[0])
def test_cqt_plans_vs_jax(case, signals):
    label, cls, kw, n = case
    j = getattr(af, cls)(samplate=SR, **kw)
    t = getattr(aft, cls)(samplate=SR, **kw, **CPU)
    assert t.fft_length == j.fft_length
    x = np.stack([signals["chord"][:n], signals["chirp"][:n]])
    got = t.cqt(x)
    _close(got, j.cqt(x), 1e-4, label)
    assert got.shape[-1] == t.cal_time_length(n) == j.cal_time_length(n)
    if label == "cqt_num24_fft16384":
        assert t.fft_length == 16384


def test_vqt_golden(goldens, signals):
    g = goldens("vqt")
    C = _np(aft.VQT(num=84, samplate=SR, beta=0.5, **CPU)
            .cqt(signals["chord"]))
    assert_close_to_golden(C.real, g["vqt_re"], 5e-5, "vqt_re")
    assert_close_to_golden(C.imag, g["vqt_im"], 5e-5, "vqt_im")


def test_cqt_set_scale_and_continue(signals):
    j = af.CQT(num=36, samplate=SR, low_fre=130.81, is_continue=True)
    t = aft.CQT(num=36, samplate=SR, low_fre=130.81, is_continue=True, **CPU)
    x = signals["sine"]
    for chunk in (x[:300], x[300:5000], x[5000:20000]):
        assert t.cal_time_length(len(chunk)) == j.cal_time_length(len(chunk))
        got, ref = t.cqt(chunk), np.asarray(j.cqt(chunk))
        assert got.shape == ref.shape
        if ref.size:
            _close(got, ref, 1e-4, "stream")
    for plan in (j, t):
        plan.set_scale(False)
    _close(t.cqt(x[20000:]), j.cqt(x[20000:]), 1e-4, "set_scale(False)")


@pytest.mark.parametrize("i", range(16))
def test_fuzz_cqt_golden(goldens, signals, i):
    g = goldens("fuzz_cqt")
    p = json.loads(str(g[f"c{i}_params"]))
    t = aft.CQT(num=p["num"], samplate=SR, low_fre=p["low"],
                bin_per_octave=p["bpo"], factor=p["factor"], beta=p["beta"],
                thresh=p["thresh"], window_type=WindowType(p["window"]),
                normal_type=NT(p["normal"]), is_scale=p["is_scale"], **CPU)
    mag = np.abs(_np(t.cqt(signals["sine"])))
    assert_close_to_golden(mag, g[f"c{i}_mag"], 5e-4, f"fuzz_cqt[{i}] {p}")
    np.testing.assert_allclose(t.get_fre_band_arr(), g[f"c{i}_fre"],
                               rtol=2e-5, atol=2e-3)


# (source, target): p/q = 1/2, 2/3 and 4/3 against the JAX package (whose
# resampler compiles one convolution a phase, too slow here at large p)
_RATIOS = [(2, 1), (48000, 32000), (24000, 32000)]


@pytest.mark.parametrize("quality", list(Q), ids=lambda q: q.name)
@pytest.mark.parametrize("ratio", _RATIOS, ids=lambda r: f"{r[0]}-{r[1]}")
def test_resample_vs_jax(ratio, quality, signals):
    x = np.stack([signals["chirp"][:9000], signals["sine"][:9000]])
    j, t = jrs.Resample(quality), trs.Resample(quality, **CPU)
    for plan in (j, t):
        plan.set_samplate(*ratio)
    assert np.array_equal(t._plan().filts, j._plan().filts)
    got = t.resample(x)
    _close(got, j.resample(x), 1e-5, f"{ratio} {quality.name}")
    _close(t.resample(x[0]), got[0], 0.0, "1-D")


def _direct_resample(x, plan, out_len):
    """The per-phase strided correlation, one phase at a time in float64:
    output k*p + r is phase r's taps dotted with the padded input from
    k*q + base[r] + 1 on (the TPU package's form)."""
    p, q, taps = plan.p, plan.q, plan.filts.shape[-1]
    xp = np.pad(x.astype(np.float64), [(0, 0), (plan.max_l, taps + q * p)])
    out = np.zeros((x.shape[0], out_len))
    for r in range(p):
        k = np.arange(-(-(out_len - r) // p))
        idx = plan.base[r] + 1 + k[:, None] * q + np.arange(taps)
        out[:, k * p + r] = xp[:, idx] @ plan.filts[r].astype(np.float64)
    return out


@pytest.mark.parametrize("quality", [Q.BEST, Q.FAST], ids=lambda q: q.name)
@pytest.mark.parametrize("ratio", [(32000, 44100), (999, 890)],
                         ids=lambda r: f"{r[0]}-{r[1]}")
def test_resample_large_ratio(ratio, quality, signals):
    """p = 441 and p = 890; at 890/999 each phase's taps are shorter than
    the stride q, where the port's windows still overlap by taps - 1."""
    x = np.stack([signals["chirp"][:9000], signals["sine"][:9000]])
    j, t = jrs.Resample(quality), trs.Resample(quality, **CPU)
    for plan in (j, t):
        plan.set_samplate(*ratio)
    plan = t._plan()
    assert np.array_equal(plan.filts, j._plan().filts)
    assert plan.base == j._plan().base
    if ratio == (999, 890):
        assert plan.filts.shape[-1] <= plan.q
    got = t.resample(x)
    assert got.shape[-1] == t.cal_data_length(9000) == int(9000 * t.ratio)
    _close(got, _direct_resample(x, plan, got.shape[-1]), 1e-5,
           f"{ratio} {quality.name}")


def test_window_resample_and_scale(signals):
    x = signals["chirp"][:7000]
    for win, value in ((WindowType.HANN, None), (WindowType.GAUSS, 3.0),
                       (WindowType.KAISER, -1.0)):
        kw = dict(zero_num=16, nbit=7, win_type=win, value=value,
                  roll_off=0.9, is_scale=True)
        j, t = jrs.WindowResample(**kw), trs.WindowResample(**kw, **CPU)
        for plan in (j, t):
            plan.set_samplate(48000, 32000)
        _close(t.resample(x), j.resample(x), 1e-5, win.name)
        assert t.cal_data_length(7000) == j.cal_data_length(7000)


def test_resample_streaming(signals):
    """is_continue: per-chunk q-multiple truncation (the C's lengths), and
    the tail_carry=True mode, both equal to the JAX package's chunks (at
    2:3; tests/test_cqt.py takes 441/640, whose JAX form compiles slowly)."""
    x = np.asarray(signals["chirp"][:30000], np.float32)
    chunks = [x[:7000], x[7000:15500], x[15500:]]
    for carry in (False, True):
        j = jrs.Resample(is_continue=True, tail_carry=carry)
        t = trs.Resample(is_continue=True, tail_carry=carry, **CPU)
        for plan in (j, t):
            plan.set_samplate(48000, 32000)
        for c in chunks:
            assert t.cal_data_length(len(c)) == j.cal_data_length(len(c))
            _close(t.resample(c), j.resample(c), 1e-5, f"carry={carry}")
        t.enable_continue(False)
        assert t._tail is None and not t.is_continue
    with pytest.raises(ValueError):
        trs.Resample(is_continue=True, **CPU).resample(np.zeros((2, 100)))


@pytest.mark.parametrize("i", range(6))
def test_fuzz_resample_golden(goldens, signals, i):
    g = goldens("fuzz_resample")
    p = json.loads(str(g[f"c{i}_params"]))
    t = trs.Resample(getattr(Q, p["q"]), is_scale=p["is_scale"], **CPU)
    t.set_samplate(p["src"], p["dst"])
    y = _np(t.resample(signals["sine"][:9000]))
    tol = 4e-3 if p["dst"] == 44100 else 3e-5
    assert_close_to_golden(y, g[f"c{i}_y"], tol, f"fuzz_resample[{i}] {p}")


def test_module_resample(signals):
    x = signals["sine"][:9000]
    for re_type in ("scipy", "scipy_poly"):
        np.testing.assert_array_equal(
            aft.resample(x, 32000, 16000, re_type),
            np.asarray(af.resample(x, 32000, 16000, re_type)))
    assert aft.resample(x, 16000, 16000) is not None
    for bad in ((32000, 44100, "scipy"), (32000, 16000, "fft")):
        with pytest.raises(ValueError):
            aft.resample(x, *bad)


# every new one-shot, against JAX's and (where the reference has one)
# its golden
_ONE_SHOTS = [
    ("linear_spectrogram", dict(radix2_exp=10, slide_length=256)),
    ("linear_spectrogram", dict(num=200, radix2_exp=10, low_fre=300.0,
                                data_type=D.MAG, is_reassign=True)),
    ("mfcc", dict(cc_num=13, radix2_exp=11, slide_length=512)),
    ("bfcc", dict(cc_num=13, radix2_exp=11, slide_length=512)),
    ("gtcc", dict(cc_num=13, radix2_exp=11, slide_length=512)),
    ("cqt", dict(num=84)),
    ("vqt", dict(num=84)),
    ("cqcc", dict(cc_num=13, cqt_num=84)),
]


@pytest.mark.parametrize("case", _ONE_SHOTS, ids=lambda c: c[0])
def test_one_shots_vs_jax(case, signals):
    fn, kw = case
    x = np.stack([signals["sine"][:12000], signals["chord"][:12000]])
    arr, fre = getattr(aft, fn)(x, samplate=SR, **kw, **CPU)
    arr_j, fre_j = getattr(af, fn)(x, samplate=SR, **kw)
    assert isinstance(arr, torch.Tensor) and not arr.is_complex()
    if kw.get("is_reassign"):
        assert_flips_and_mass(arr, arr_j, fn)
    else:
        _close(arr, arr_j, 1e-4, fn)
    np.testing.assert_array_equal(fre, fre_j)


@pytest.mark.parametrize("fn,kw", [
    ("chroma_linear", dict(radix2_exp=11, slide_length=512)),
    ("chroma_linear", dict(chroma_num=24, low_fre=100.0, high_fre=8000.0,
                           norm_type=ChromaDataNormalType.P2)),
    ("chroma_octave", dict(radix2_exp=12, slide_length=1024)),
    ("chroma_octave", dict(radix2_exp=12, chroma_num=4,
                           norm_type=ChromaDataNormalType.P1)),
    ("chroma_cqt", dict(num=84)),
    ("chroma_cqt", dict(num=60, low_fre=65.41, data_type=D.MAG,
                        norm_type=ChromaDataNormalType.NONE)),
])
def test_chroma_one_shots_vs_jax(fn, kw, signals):
    x = signals["chord"][:20000]
    _close(getattr(aft, fn)(x, samplate=SR, **kw, **CPU),
           getattr(af, fn)(x, samplate=SR, **kw), 1e-4, fn)


@pytest.mark.parametrize("i", range(14))
def test_fuzz_core_one_shot_golden(goldens, signals, i):
    g = goldens("fuzz_core")
    p = json.loads(str(g[f"c{i}_params"]))
    arr, fre = getattr(aft, p["fn"])(signals["sine"], samplate=SR,
                                     **p["kw"], **CPU)
    tol = 5e-4 if p["fn"] in ("cqcc", "cqt", "vqt") else 2e-4
    assert_close_to_golden(_np(arr), g[f"c{i}_arr"], tol,
                           f"fuzz_core[{i}] {p}")
    np.testing.assert_allclose(np.asarray(fre, np.float32), g[f"c{i}_fre"],
                               rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("i", range(6))
def test_fuzz_chroma_one_shot_golden(goldens, i):
    g = goldens("fuzz_chroma")
    p = json.loads(str(g[f"c{i}_params"]))
    t = np.arange(SR) / SR
    x = (0.3 * np.sin(2 * np.pi * 261.63 * t)
         + 0.3 * np.sin(2 * np.pi * 392.0 * t)
         + 0.02 * np.random.default_rng(9).standard_normal(SR)
         ).astype(np.float32)  # gen_goldens._chroma_fuzz_signal
    arr = getattr(aft, p["fn"])(x, samplate=SR, **p["kw"], **CPU)
    assert_close_to_golden(_np(arr), g[f"c{i}_arr"], 5e-4,
                           f"fuzz_chroma[{i}] {p}")


def test_chroma_golden_through_chroma_linear(goldens, signals):
    arr = aft.chroma_linear(signals["chord"], radix2_exp=11, slide_length=512,
                            low_fre=0.0, high_fre=16000.0, **CPU)
    assert_close_to_golden(_np(arr), goldens("chroma")["chroma_spec"], 2e-4,
                           "chroma_spec")


def _perturbed(a, seed):
    rng = np.random.default_rng(seed)
    return (np.asarray(a) * (1 + 0.05 * rng.random(np.shape(a)))
            ).astype(np.asarray(a).dtype)


def test_load_reference_constants_bft_reassign_cqt(signals):
    """JAX's constants, perturbed, installed on the port's plans: the port
    then computes what JAX computes from them."""
    x = signals["chord"][:12000]
    # BFT: the window (its reassignment windows follow) and the bank
    kw = dict(num=64, radix2_exp=10, samplate=SR, slide_length=256,
              scale_type=S.MEL, data_type=D.POWER)
    j, t = af.BFT(**kw), aft.BFT(**kw, **CPU)
    win = _perturbed(j._re._wins[0], 1)
    fb = _perturbed(j.filter_bank, 2)
    aft.load_reference_constants(t, window=win, filter_bank=fb)
    j.filter_bank = fb
    j._re._wins = np.stack(af.transforms.reassign.reassign_windows(win))
    _close(t.bft(x, result_type=1), j.bft(x, result_type=1), 1e-4, "bft")
    _close(t.bft_fused(x, cc_num=3)[0], j.bft(x, result_type=1), 1e-4,
           "bft_fused")
    # Reassign: the three windows
    j, t = (af.Reassign(radix2_exp=10, samplate=SR),
            aft.Reassign(radix2_exp=10, samplate=SR, **CPU))
    j._wins = _perturbed(j._wins, 3)
    aft.load_reference_constants(t, wins=j._wins)
    assert_flips_and_mass(t.reassign(x), j.reassign(x), "reassign")
    # CQT (VQT: a kernel per octave): kernels, resampler taps, DCT, scale
    j, t = (af.VQT(num=36, samplate=SR, low_fre=130.81),
            aft.VQT(num=36, samplate=SR, low_fre=130.81, **CPU))
    j._kernels = [_perturbed(k, 4 + i) for i, k in enumerate(j._kernels)]
    rs = j._resampler._plan()
    rs.filts = _perturbed(rs.filts, 9)
    scale = _perturbed(j._scale_vec(), 10)
    j._scale_vec = lambda: scale
    j._dct = _perturbed(j._dct, 11)
    aft.load_reference_constants(t, kernels=j._kernels,
                                 resample_filts=rs.filts, dct=j._dct,
                                 scale_vec=scale)
    C = t.cqt(x)
    _close(C, j.cqt(x), 1e-4, "cqt")
    mag = np.abs(_np(C))
    _close(t.cqcc(mag), j.cqcc(mag), 1e-4, "cqcc")
    # Spectral: the band frequencies
    fre = np.linspace(10, 9000, 36).astype(np.float32)
    ts = aft.Spectral(36, np.zeros(36), **CPU)
    aft.load_reference_constants(ts, fre_band_arr=fre)
    _close(ts.centroid(mag), af.Spectral(36, fre).centroid(mag), 1e-5,
           "centroid")
    with pytest.raises(ValueError):
        aft.load_reference_constants(t, kernels=j._kernels[:2])
    with pytest.raises(ValueError):
        aft.load_reference_constants(ts, fre_band_arr=fre[:5])


_PLAN_MAKERS = [
    ("BFT", lambda **d: aft.BFT(num=64, radix2_exp=10, **d)),
    ("Reassign", lambda **d: aft.Reassign(radix2_exp=10, **d)),
    ("Temporal", lambda **d: aft.Temporal(**d)),
    ("Spectral", lambda **d: aft.Spectral(8, np.arange(8), **d)),
    ("Deconv", lambda **d: aft.Deconv(8, **d)),
    ("Onset", lambda **d: aft.Onset(10, 8, 512, **d)),
    ("Resample", lambda **d: aft.Resample(**d)),
    ("WindowResample", lambda **d: aft.WindowResample(**d)),
    ("CQT", lambda **d: aft.CQT(num=24, low_fre=523.25, **d)),
    ("VQT", lambda **d: aft.VQT(num=24, low_fre=523.25, **d)),
    ("SimpleCQT", lambda **d: aft.SimpleCQT(num=24, low_fre=523.25, **d)),
]
_NEW_ONE_SHOTS = ["linear_spectrogram", "mfcc", "bfcc", "gtcc", "cqt", "vqt",
                  "cqcc", "chroma_linear", "chroma_octave", "chroma_cqt"]


def test_device_policy_of_the_new_plans(monkeypatch):
    """``device=None`` means cuda and raises without it; ``device="cpu"``
    runs; a CPU plan refuses a tensor that lies elsewhere."""
    x = np.random.default_rng(0).standard_normal(8192).astype(np.float32)
    for name, make in _PLAN_MAKERS:
        plan = make(**CPU)
        assert plan.device == torch.device("cpu"), name
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for name, make in _PLAN_MAKERS:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        for fn in _NEW_ONE_SHOTS:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                getattr(aft, fn)(x, radix2_exp=10) if fn in (
                    "linear_spectrogram", "chroma_linear",
                    "chroma_octave") else getattr(aft, fn)(x)
    for fn in _NEW_ONE_SHOTS:
        kw = dict(radix2_exp=10) if fn in ("linear_spectrogram", "mfcc",
                                           "bfcc", "gtcc", "chroma_linear",
                                           "chroma_octave") else {}
        out = getattr(aft, fn)(x, **kw, **CPU)
        out = out[0] if isinstance(out, tuple) else out
        assert out.device.type == "cpu" and bool(torch.isfinite(out).all())
    bft = aft.BFT(num=64, radix2_exp=10, **CPU)
    with pytest.raises(ValueError):
        bft.bft(torch.zeros(4096, device="meta"))


def test_no_module_of_the_port_imports_jax():
    """Every module of audioflux_torch, imported in a fresh interpreter,
    pulls in neither jax nor audioflux_tpu."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        aft.__path__, "audioflux_torch."))
    assert {"audioflux_torch.transforms.bft", "audioflux_torch.mir.onset",
            "audioflux_torch.dsp.resample",
            "audioflux_torch.transforms.cqt"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'audioflux_tpu'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
