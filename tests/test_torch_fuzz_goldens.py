"""The port against the seven fuzz golden groups that the JAX package's
``tests/test_fuzz_goldens.py`` reads: ``fuzz_edges``, ``fuzz_harmonic``,
``fuzz_pitch``, ``fuzz_wavelet``, ``fuzz_utils``, ``fuzz_mir2`` and
``fuzz_stft`` (62 cases, seeded random configurations of the reference C
library), on ``device="cpu"``, parametrised as that file is and at its
tolerances.

One case is held in two parts: ``fuzz_mir2[5]`` (HPSS, HANN, radix2_exp
11, slide 512).  At the ISTFT's first and last samples the HANN window's
energy sum falls to 1.5e-6, just above ``_ola_frames``' 1e-6 floor, so the
division there amplifies any float32 rounding of the inverse transform by
about 600x: the golden reads 4.9e-5 of the peak from a float64 run at
sample 22, the port 6.0e-5 at its last samples.  The interior is held
against the golden at the JAX test's 5e-5; the whole length against a
float64 run of the port's own code at 1e-6 of the peak, times each
sample's amplification (see ``_ola_amplification``)."""

import json
import math

import numpy as np
import pytest
import torch

import audioflux_torch as aft
from audioflux_torch import utils as U
from audioflux_torch.features.spectral import Spectral
from audioflux_torch.mir import hpss as hpss_mod
from audioflux_torch.ops.cuda_median import median_filter_last_axis_ref
from audioflux_torch.types import (PaddingModeType, PaddingPositionType,
                                   SpectralFilterBankNormalType,
                                   SpectralFilterBankScaleType,
                                   SpectralFilterBankStyleType,
                                   WaveletContinueType, WindowType)
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}
SR = 32000
N_WAVELET_CASES = 14
N_MIR2_CASES = 14
N_STFT_FUZZ = 14
# fuzz_mir2[5]: the edge samples left out of the interior gate, and the
# whole length's bound against float64 before the OLA's amplification
HPSS_EDGE = 2048
HPSS_F64_TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tone(*parts):
    t = np.arange(SR) / SR
    return sum(a * np.sin(2 * np.pi * f * t) for a, f in parts).astype(
        np.float32)


@pytest.mark.parametrize("i", range(4))
def test_fuzz_harmonic_count(goldens, i):
    g = goldens("fuzz_harmonic")
    p = json.loads(str(g[f"h{i}_params"]))
    h = aft.Harmonic(radix2_exp=p["r2e"], samplate=SR,
                     slide_length=p["slide"],
                     window_type=getattr(WindowType, p["window"]),
                     low_fre=p["low"], high_fre=p["high"], **CPU)
    counts = np.asarray(h.harmonic_count(g["in_tone"], *p["q"]), np.int64)
    np.testing.assert_array_equal(counts, g[f"h{i}_counts"],
                                  err_msg=f"fuzz_harmonic[{i}] {p}")


@pytest.mark.parametrize("i", range(3))
def test_fuzz_harmonic_ratio(goldens, i):
    # HAMM: the C's hardcoded window (it never reads windowType)
    g = goldens("fuzz_harmonic")
    p = json.loads(str(g[f"r{i}_params"]))
    hr = aft.HarmonicRatio(samplate=SR, radix2_exp=p["r2e"],
                           window_type=WindowType.HAMM,
                           slide_length=p["slide"], **CPU)
    out = _np(hr.harmonic_ratio(g["in_tone"]))
    assert_close_to_golden(out, g[f"r{i}_hr"], 5e-5, f"fuzz_hr[{i}] {p}")


@pytest.mark.parametrize("i", range(10))
def test_fuzz_pitch_case(goldens, i):
    """The pitch engines under non-default fft/slide/range parameters."""
    g = goldens("fuzz_pitch")
    p = json.loads(str(g[f"c{i}_params"]))
    tone = _tone((0.5, 220), (0.25, 440), (0.12, 660))
    kw = dict(p.get("kw", {}))
    if "window_type" in kw:
        kw["window_type"] = getattr(WindowType, kw["window_type"])
    obj = getattr(aft, p["cls"])(samplate=SR, low_fre=p["low"],
                                 high_fre=p["high"], radix2_exp=p["r2e"],
                                 slide_length=p["slide"], **kw, **CPU)
    res = obj.pitch(tone)
    fre = _np(res[0] if isinstance(res, tuple) else res)
    np.testing.assert_allclose(fre, g[f"c{i}_fre"], atol=1e-3,
                               err_msg=f"fuzz_pitch[{i}] {p}")


@pytest.mark.parametrize("name", ["blocks", "sparse"])
def test_fuzz_edge_arr(goldens, name):
    """Non-contiguous ``set_edge_arr`` band subsets."""
    g = goldens("fuzz_edges")
    spec = g["in_spec"]
    sp = Spectral(128, g["in_fre"], **CPU)
    sp.set_edge_arr(g[f"{name}_idx"].astype(np.int64))
    for feat, kw in (("centroid", {}), ("spread", {}), ("hfc", {}),
                     ("rms", {}), ("flux", {}),
                     ("entropy", {"is_norm": True}), ("eef", {})):
        ours = _np(getattr(sp, feat)(spec, **kw))
        assert_close_to_golden(ours, g[f"{name}_{feat}"], 2e-4,
                               f"edge_{name}_{feat}")
    v, f = sp.max(spec)
    assert_close_to_golden(_np(v), g[f"{name}_max_v"], 2e-4,
                           f"edge_{name}_max_v")
    assert_close_to_golden(_np(f), g[f"{name}_max_f"], 2e-4,
                           f"edge_{name}_max_f")


@pytest.mark.parametrize("i", range(N_WAVELET_CASES))
def test_fuzz_wavelet_case(goldens, signals, i):
    g = goldens("fuzz_wavelet")
    p = json.loads(str(g[f"c{i}_params"]))
    S = SpectralFilterBankScaleType
    if "wavelet" in p:
        x = signals["sine"][:1 << p["r2e"]]
        obj = aft.CWT(num=p["num"], radix2_exp=p["r2e"], samplate=SR,
                      low_fre=p.get("low"), high_fre=p.get("high"),
                      wavelet_type=getattr(WaveletContinueType, p["wavelet"]),
                      scale_type=getattr(S, p["scale"]),
                      gamma=p["gamma"], beta=p["beta"], **CPU)
        C = _np(obj.cwt(x))
    else:
        x = signals["sine"][:4096]
        obj = aft.PWT(num=p["num"], radix2_exp=12, samplate=SR,
                      low_fre=p.get("low"), high_fre=p.get("high"),
                      scale_type=getattr(S, p["scale"]),
                      style_type=getattr(SpectralFilterBankStyleType,
                                         p["style"]),
                      normal_type=getattr(SpectralFilterBankNormalType,
                                          p["norm"]), **CPU)
        C = _np(obj.pwt(x))
    ref = g[f"c{i}_re"] + 1j * g[f"c{i}_im"]
    assert_close_to_golden(C.real, ref.real, 2e-4, f"fuzz_wave[{i}] re {p}")
    assert_close_to_golden(C.imag, ref.imag, 2e-4, f"fuzz_wave[{i}] im {p}")
    np.testing.assert_allclose(np.asarray(obj.get_fre_band_arr(), np.float32),
                               g[f"c{i}_fre"], rtol=2e-5, atol=2e-3,
                               err_msg=f"fuzz_wave[{i}] fre {p}")


def test_fuzz_every_utility(goldens):
    """Every utility against the reference wrapper's output."""
    g = goldens("fuzz_utils")
    spec = g["in_spec"]
    D = g["in_d_re"] + 1j * g["in_d_im"]
    fre = g["in_fre"]
    midi = np.arange(21, 109, dtype=np.float32)

    def close(ours, key, tol=1e-5):
        ours = [_np(o) for o in ours] if isinstance(ours, list) else _np(ours)
        np.testing.assert_allclose(np.asarray(ours, np.float64),
                                   np.asarray(g[key], np.float64),
                                   rtol=tol, atol=tol, err_msg=key)

    close(U.power_to_db(spec), "power_to_db")
    close(U.power_to_db(spec, min_db=-40), "power_to_db_m40")
    close(U.power_to_abs_db(spec), "power_to_abs_db")
    close(U.power_to_abs_db(spec, fft_length=2048, is_norm=True),
          "power_to_abs_db_norm")
    close(U.mag_to_abs_db(spec), "mag_to_abs_db")
    close(U.log_compress(spec, gamma=5.0), "log_compress")
    close(U.log10_compress(spec, gamma=5.0), "log10_compress")
    tdb = U.temproal_db(spec[0], base=18.0)
    close(tdb[0], "temproal_db")
    close(tdb[1], "temproal_db_energy")
    close(U.delta(spec, order=9), "delta_9")
    close(U.delta(spec, order=5), "delta_5")
    close(U.get_phase(D), "get_phase")
    close(U.midi_to_hz(midi), "midi_to_hz")
    close(U.hz_to_midi(fre), "hz_to_midi")
    close([U.note_to_midi(n) for n in ("C1", "A4", "G#3", "Bb5", "F#2")],
          "note_vals")
    close(U.min_max_scale(spec), "min_max")
    close(U.stand_scale(spec), "stand")
    close(U.max_abs_scale(spec), "max_abs")
    close(U.robust_scale(spec), "robust")
    close(U.center_scale(spec), "center")
    close(U.mean_scale(spec), "mean")
    close(U.arctan_scale(spec), "arctan")
    close(U.auditory_weight_a(fre), "wa", 1e-4)
    close(U.auditory_weight_b(fre), "wb", 1e-4)
    close(U.auditory_weight_c(fre), "wc", 1e-4)
    close(U.auditory_weight_d(fre), "wd", 1e-4)
    close(U.queue_fre2(220.0, 446.0), "qf2")
    close(U.queue_fre3(220.0, 446.0, 655.0), "qf3")


def _peak_freq(y, sr=SR):
    w = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    return np.argmax(w) * sr / len(y)


class _Float64FFT:
    """``ops.fft``'s two calls that HPSS makes, as ``torch.fft`` in the
    input's own precision (the kernel tier takes float32 only)."""
    fft = staticmethod(lambda x, dim=-1: torch.fft.fft(x, dim=dim))
    ifft = staticmethod(lambda x, dim=-1: torch.fft.ifft(x, dim=dim))


def _hpss_float64(hp, x, monkeypatch):
    """The port's own HPSS code run in float64: its FFTs through
    ``torch.fft`` and its medians through the plain version."""
    monkeypatch.setattr(hpss_mod, "afft", _Float64FFT)
    monkeypatch.setattr(hpss_mod, "median_filter_last_axis",
                        median_filter_last_axis_ref)
    window = torch.from_numpy(np.asarray(hp.window, np.float64))
    return hpss_mod._hpss_impl(
        torch.from_numpy(np.asarray(x, np.float64)), window,
        fft_length=hp.fft_length, slide_length=hp.slide_length,
        h_order=hp.h_order, p_order=hp.p_order)


def _ola_amplification(window, slide, out_len):
    """How much the weighted overlap-add's division amplifies an error of
    the inverse transform at each output sample, relative to the interior:
    sum |w| over sum w^2 (floored as ``_ola_frames`` floors it), over its
    median."""
    n = len(window)
    w = np.asarray(window, np.float64)
    s1 = np.zeros(out_len + n)
    s2 = np.zeros(out_len + n)
    for start in range(0, out_len - n + 1, slide):
        s1[start:start + n] += np.abs(w)
        s2[start:start + n] += w * w
    s1, s2 = s1[:out_len], s2[:out_len]
    s2 = np.where(s2 < 1e-6, 1.0, s2)
    a = s1 / s2
    return np.maximum(a / np.median(a), 1.0)


@pytest.mark.parametrize("i", range(N_MIR2_CASES))
def test_fuzz_mir2_case(goldens, monkeypatch, i):
    """TimeStretch/PitchShift/HPSS/HarmonicRatio/NMF/Viterbi off their
    fixed-golden configurations, at the JAX test's bounds (the phase
    vocoder's documented drift bound plus pitch and duration checks)."""
    g = goldens("fuzz_mir2")
    p = json.loads(str(g[f"c{i}_params"]))
    kind = p["kind"]
    tag = f"fuzz_mir2[{i}] {p}"
    tone = _tone((0.5, 220), (0.25, 440))
    if kind == "ts":
        ts = aft.TimeStretch(radix2_exp=p["r2e"], slide_length=p["slide"],
                             window_type=getattr(WindowType, p["window"]),
                             **CPU)
        y = _np(ts.time_stretch(tone, p["rate"]))
        ref = g[f"c{i}_y"]
        # the C returns its capacity buffer ceil(n/rate)+fft, zeros after
        # the signal; the port ends at the true OLA length
        cap = math.ceil(len(tone) / p["rate"]) + (1 << p["r2e"])
        assert len(ref) == cap, tag
        n = min(len(y), len(ref))
        assert np.abs(y[:n] - ref[:n]).max() <= 0.1 * np.abs(ref).max(), tag
        assert np.abs(ref[n:]).max() <= 1e-6, tag
        assert abs(_peak_freq(y) - 220) < 6, tag
    elif kind == "ps":
        ps = aft.PitchShift(radix2_exp=p["r2e"], slide_length=p["slide"],
                            window_type=getattr(WindowType, p["window"]),
                            **CPU)
        y = _np(ps.pitch_shift(tone, p["semitone"], SR))
        ref = g[f"c{i}_y"]
        n = min(len(y), len(ref))
        assert np.abs(y[:n] - ref[:n]).max() <= 0.12 * np.abs(ref).max(), tag
        want = 220 * 2 ** (p["semitone"] / 12)
        assert abs(_peak_freq(y) - want) < 8, tag
    elif kind == "hpss":
        hp = aft.HPSS(radix2_exp=p["r2e"],
                      window_type=getattr(WindowType, p["window"]),
                      slide_length=p["slide"], h_order=p["h"],
                      p_order=p["p"], **CPU)
        outs = [_np(o) for o in hp.hpss(g[f"c{i}_in_x"])]
        refs = [g[f"c{i}_h"], g[f"c{i}_p"]]
        if i != 5:
            for got, ref in zip(outs, refs):
                assert_close_to_golden(got, ref, 5e-5, tag)
            return
        # the golden's own error at the ISTFT's edges (module docstring)
        e = HPSS_EDGE
        amp = _ola_amplification(hp.window, hp.slide_length, len(refs[0]))
        for got, ref, f64 in zip(outs, refs,
                                 _hpss_float64(hp, g[f"c{i}_in_x"],
                                               monkeypatch)):
            assert got.shape == ref.shape, tag
            peak = np.abs(ref).max()
            err = np.abs(got - ref)[e:-e].max()
            assert err <= 5e-5 * peak, (
                f"{tag} interior: {err / peak:.3e} of the peak")
            f64 = f64.numpy()
            rel = np.abs(got - f64) / (np.abs(f64).max() * amp)
            assert rel.max() <= HPSS_F64_TOL, (
                f"{tag} against float64: {rel.max():.3e} at sample "
                f"{rel.argmax()}")
    elif kind == "hr":
        hr = aft.HarmonicRatio(samplate=SR, radix2_exp=p["r2e"],
                               slide_length=p["slide"], **CPU)
        assert_close_to_golden(_np(hr.harmonic_ratio(tone)), g[f"c{i}_y"],
                               5e-5, tag)
    elif kind == "nmf":
        W, H = aft.nmf(g[f"c{i}_V"], p["k"], w_arr=g[f"c{i}_W0"],
                       h_arr=g[f"c{i}_H0"], max_iter=p["it"], tp=p["tp"],
                       thresh=1e-5, norm=p["norm"], **CPU)
        W, H = _np(W), _np(H)
        V = g[f"c{i}_V"]
        # multiplicative updates compound float32 differences: the factors
        # loosely, the reconstruction tightly; under the IS divergence
        # (tp=2) the factor paths part entirely, so only the reconstruction
        if p["tp"] < 2:
            np.testing.assert_allclose(W, g[f"c{i}_W"], atol=5e-2,
                                       err_msg=tag)
        rec_ours = np.abs(V - W @ H).mean()
        rec_ref = np.abs(V - g[f"c{i}_W"] @ g[f"c{i}_H"]).mean()
        assert rec_ours <= rec_ref * 1.05, tag
    elif kind == "viterbi":
        s, prob, m = aft.viterbi(g[f"c{i}_pi"], g[f"c{i}_A"], g[f"c{i}_B"],
                                 g[f"c{i}_o"], **CPU)
        np.testing.assert_array_equal(_np(s), g[f"c{i}_vit_s"], err_msg=tag)
        np.testing.assert_allclose(float(prob), g[f"c{i}_vit_prob"],
                                   rtol=1e-4, err_msg=tag)
        np.testing.assert_allclose(_np(m), g[f"c{i}_vit_m"], rtol=1e-4,
                                   atol=1e-12, err_msg=tag)
    else:
        raise AssertionError(f"unknown kind {kind}")


@pytest.mark.parametrize("i", range(N_STFT_FUZZ))
def test_fuzz_stft_case(goldens, signals, i):
    """STFT off its fixed-golden configuration (radix2_exp, the 14 window
    types, slides, padding, custom windows, odd lengths), and both ISTFT
    methods fed the golden spectrum where the overlap covers the
    signal."""
    g = goldens("fuzz_stft")
    p = json.loads(str(g[f"c{i}_params"]))
    tag = f"fuzz_stft[{i}] {p}"
    st = aft.STFT(radix2_exp=p["r2e"], window_type=WindowType(p["window"]),
                  slide_length=p["slide"], **CPU)
    if p["custom"]:
        st.use_window_data_arr(g[f"c{i}_win"])
    if p["pad"]:
        st.enable_padding(True)
        st.set_padding(PaddingPositionType(p["pos"]),
                       PaddingModeType(p["mode"]), p["v1"], p["v2"])
    x = signals["sine"][:p["n"]]
    D = _np(st.stft(x))
    assert_close_to_golden(D.real, g[f"c{i}_re"], 5e-5, tag)
    assert_close_to_golden(D.imag, g[f"c{i}_im"], 5e-5, tag)
    if f"c{i}_rec" in g.files:
        # the JAX test's bound: both methods divide by overlapped window
        # sums that windows with negative lobes or near-zero edges pass
        # near the C's 1e-6 clamp
        Dg = g[f"c{i}_re"] + 1j * g[f"c{i}_im"]
        y = _np(st.istft(Dg, method_type=p["method"]))
        assert_close_to_golden(y, g[f"c{i}_rec"], 1e-3, tag)
