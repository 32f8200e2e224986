"""The port's DSP one-shots on the CPU (``device="cpu"``): CZT, DCT/IDCT,
convolution in its three modes, cross- and autocorrelation in each norm,
Hilbert, the phase vocoder and FIR design, against the JAX package on the
CPU on the same seeded inputs (2e-6 of the peak unless a case says
otherwise) and against the reference C goldens at tests/test_dsp.py's and
tests/test_fuzz_goldens.py's tolerances."""

import importlib
import json

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.dsp import filter_design as jfd
from audioflux_torch.dsp import filter_design as tfd
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}
TOL = 2e-6
# the modules (both packages' dsp export a function of the same name)
jconv = importlib.import_module("audioflux_tpu.dsp.conv")
tconv = importlib.import_module("audioflux_torch.dsp.conv")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL, label=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    peak = max(np.max(np.abs(ref)), 1e-20)
    err = np.max(np.abs(got - ref))
    assert err <= tol * peak, f"{label}: rel err {err / peak:.3e} > {tol}"


def _rand(*shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n,lo,hi,m", [(2048, 0.1, 0.3, None),
                                       (300, 0.0, 1.0, None),
                                       (1000, 0.05, 0.07, 257),
                                       (4096, 0.2, 0.25, None)])
def test_czt_vs_jax(n, lo, hi, m):
    x = _rand(2, n)
    _close(aft.czt(x, lo, hi, m, **CPU), af.czt(x, lo, hi, m),
           label=f"czt {n} {lo} {hi} {m}")
    z = (x + 1j * _rand(2, n, seed=6)).astype(np.complex64)
    _close(aft.czt(z, lo, hi, m, **CPU), af.czt(z, lo, hi, m),
           label="complex input")


def test_czt_plan():
    x = _rand(128)
    out = aft.CZT(7, **CPU).czt(x, 0.1, 0.3)
    ks = 0.1 + np.arange(128) * 0.2 / 128
    direct = np.array([(x * np.exp(-2j * np.pi * w * np.arange(128))).sum()
                       for w in ks])
    np.testing.assert_allclose(_np(out), direct, atol=1e-3)
    with pytest.raises(ValueError):
        aft.CZT(7, **CPU).czt(x, 0.5, 0.2)


@pytest.mark.parametrize("norm", [False, True])
def test_dct_idct_vs_jax(norm):
    x = _rand(3, 5, 64)
    _close(aft.dct(x, norm, **CPU), af.dct(x, norm), label="dct")
    _close(aft.idct(x, norm, **CPU), af.idct(x, norm), label="idct")
    d = aft.DCT(64, **CPU)
    _close(d.idct(d.dct(x, norm), norm), x, 1e-5, "round trip")


@pytest.mark.parametrize("mode", list(aft.dsp.ConvModeType))
@pytest.mark.parametrize("m", [1, 8, 37, 102, 300])
def test_conv_vs_jax(mode, m):
    x, h = _rand(3, 1000), _rand(m, seed=7)
    _close(aft.dsp.conv(x, h, mode, **CPU), jconv.conv(x, h, mode),
           label=f"conv {mode.name} m={m}")


def test_window_product_in_chunks(monkeypatch):
    """Windows copied in several chunks (a small cap) give the one-chunk
    result (to the rounding of a product of another shape) and the
    definition, for a vector and a matrix of taps, strided and dilated."""
    x = torch.from_numpy(_rand(2, 3, 700))
    taps1 = torch.from_numpy(_rand(9, seed=8))
    taps2 = torch.from_numpy(_rand(9, 2, seed=9))
    cases = [(taps1, 692, 1, 1), (taps2, 346, 2, 1), (taps2, 600, 1, 12)]
    whole = [tconv.window_product(x, t, c, s, d) for t, c, s, d in cases]
    monkeypatch.setattr(tconv, "_MAX_CELLS", 200)
    for (t, c, s, d), ref in zip(cases, whole):
        got = tconv.window_product(x, t, c, s, d)
        _close(got, ref, label=f"chunks {c} {s} {d}")
        # against the definition
        q = np.arange(c)[:, None] * s + np.arange(t.shape[0])[None, :] * d
        direct = np.einsum("...qm,m...->...q" if t.dim() == 1 else
                           "...qm,mk->...qk", x.numpy()[..., q], t.numpy())
        _close(got, direct, label=f"definition {c} {s} {d}")


@pytest.mark.parametrize("norm", list(aft.XcorrNormalType))
@pytest.mark.parametrize("n", [256, 2048])
def test_xcorr_vs_jax(norm, n):
    x, y = _rand(3, n), _rand(3, n, seed=10)
    for other in (y, None):
        out, idx, val = aft.xcorr(x, other, norm, **CPU)
        jout, jidx, jval = af.xcorr(x, other, norm)
        _close(out, jout, label=f"xcorr {norm.name} {other is None}")
        assert np.array_equal(_np(idx), np.asarray(jidx))
        _close(val, jval)
    out = aft.Xcorr(**CPU).xcorr(x, y)           # NONE by default
    _close(out[0], af.Xcorr().xcorr(x, y)[0], label="Xcorr plan")


@pytest.mark.parametrize("n,L", [(256, None), (2048, None), (1000, 4096)])
def test_hilbert_vs_jax(n, L):
    x = _rand(2, n)
    _close(aft.hilbert(x, L, **CPU), af.hilbert(x, L), label=f"{n} {L}")
    z = aft.Hilbert(radix2_exp=8, **CPU).hilbert(x[:, :256])
    _close(z.real, x[:, :256], 1e-6, "real part is the input")


def _pv_float64(D, slide, rate):
    """The phase vocoder's recurrence written out in float64, step by step
    (the model both packages round differently)."""
    Dt = np.swapaxes(D, -1, -2).astype(np.complex128)
    T, m = Dt.shape[-2:]
    phi = np.linspace(0, np.pi * slide, m)
    times = np.arange(0, T, rate)[:int(np.ceil(T / rate))]
    phase, outs = np.angle(Dt[..., 0, :]), []
    zero = np.zeros_like(Dt[..., 0, :])
    for t in times:
        k, a = int(np.floor(t)), t - np.floor(t)
        A = Dt[..., k, :] if k < T else zero
        B = Dt[..., k + 1, :] if k + 1 < T else zero
        outs.append(((1 - a) * np.abs(A) + a * np.abs(B))
                    * np.exp(1j * phase))
        dev = np.angle(B) - np.angle(A) - phi
        phase = phase + phi + dev - 2 * np.pi * np.round(dev / (2 * np.pi))
    return np.swapaxes(np.stack(outs, -2), -1, -2)


@pytest.mark.parametrize("rate", [0.8, 1.25, 2.0])
def test_phase_vocoder(rate):
    """Magnitudes against the JAX package at 1e-4 of the peak.  The phase
    adds up over the frames (to ~pi*slide*T); the port sums it in float64,
    the JAX package in float32, so the complex output is held against the
    float64 recurrence: the port at 1e-2 of the peak, and closer to it
    than the JAX package's (measured at 0.27-0.45% against 7-16%)."""
    x = _rand(2, 32000)
    D = np.asarray(af.STFT(radix2_exp=10, window_type=af.WindowType.HANN,
                           slide_length=256).stft(x))
    got = _np(aft.phase_vocoder(D, 256, rate, **CPU))
    jax_out = np.asarray(af.phase_vocoder(D, 256, rate))
    _close(np.abs(got), np.abs(jax_out), 1e-4, "magnitudes")
    ref = _pv_float64(D, 256, rate)
    peak = np.abs(ref).max()
    port_err = np.abs(got - ref).max() / peak
    jax_err = np.abs(jax_out - ref).max() / peak
    assert port_err <= 1e-2, port_err
    assert port_err < jax_err, (port_err, jax_err)


def test_dsp_goldens(goldens):
    g = goldens("dsp")
    out, idx, _ = aft.Xcorr(**CPU).xcorr(g["x"], g["y"],
                                         aft.XcorrNormalType.COEFF)
    np.testing.assert_allclose(_np(out), g["xcorr"], atol=1e-5)
    assert int(idx) == int(g["xcorr_idx"])
    out, idx, _ = aft.Xcorr(**CPU).xcorr(
        g["x"], xcorr_normal_type=aft.XcorrNormalType.COEFF)
    np.testing.assert_allclose(_np(out), g["autocorr"], atol=1e-5)
    assert int(idx) == 255
    z = _np(aft.Hilbert(radix2_exp=8, **CPU).hilbert(g["x"]))
    np.testing.assert_allclose(z.real, g["hilb_re"], atol=1e-5)
    np.testing.assert_allclose(z.imag, g["hilb_im"], atol=1e-5)
    d = aft.DCT(64, **CPU)
    out = d.dct(g["dct_in"], is_norm=True)
    np.testing.assert_allclose(_np(out), g["dct_out"], atol=2e-4)
    np.testing.assert_allclose(_np(d.idct(out, is_norm=True)), g["dct_in"],
                               atol=1e-4)


@pytest.mark.parametrize("i", range(19))      # test_fuzz_goldens N_DSP_FUZZ
def test_fuzz_dsp_goldens(goldens, i):
    g = goldens("fuzz_dsp")
    p = json.loads(str(g[f"c{i}_params"]))
    tag = f"fuzz_dsp[{i}] {p}"
    kind = p["kind"]
    if kind == "hilbert":
        z = _np(aft.Hilbert(radix2_exp=p["r2e"], **CPU).hilbert(g[f"c{i}_x"]))
        assert_close_to_golden(z.real, g[f"c{i}_re"], 5e-5, tag)
        assert_close_to_golden(z.imag, g[f"c{i}_im"], 5e-5, tag)
    elif kind == "dct":
        y = aft.dct(g[f"c{i}_x"], is_norm=bool(p["norm"]), **CPU)
        assert_close_to_golden(_np(y), g[f"c{i}_y"], 5e-5, tag)
    elif kind == "xcorr":
        y = None if p["auto"] else g[f"c{i}_y"]
        arr = aft.xcorr(g[f"c{i}_x"], y, aft.XcorrNormalType(p["norm"]),
                        **CPU)[0]
        assert_close_to_golden(_np(arr), g[f"c{i}_arr"], 5e-5, tag)
    elif kind == "czt":
        C = _np(aft.czt(g[f"c{i}_x"], p["low"], p["high"], **CPU))
        assert_close_to_golden(C.real, g[f"c{i}_re"], 5e-4, tag)
        assert_close_to_golden(C.imag, g[f"c{i}_im"], 5e-4, tag)
    else:
        assert kind == "conv", tag
        full = g[f"c{i}_y"]
        n, m = p["nx"], p["nh"]
        mode = aft.dsp.ConvModeType(p["mode"])
        if mode == aft.dsp.ConvModeType.FULL:
            want = full
        elif mode == aft.dsp.ConvModeType.SAME:
            start = m // 2 - (0 if m % 2 else 1)
            want = full[start:start + n]
        else:
            want = full[m - 1:n]
        out = aft.dsp.conv(g[f"c{i}_x"], g[f"c{i}_h"], mode, **CPU)
        assert_close_to_golden(_np(out), want, 5e-5, tag)


@pytest.mark.parametrize("band,wc,order", [
    (aft.dsp.FilterBandType.LOW_PASS, [0.25], 64),
    (aft.dsp.FilterBandType.HIGH_PASS, [0.5], 64),
    (aft.dsp.FilterBandType.BAND_PASS, [0.2, 0.4], 128),
    (aft.dsp.FilterBandType.BAND_STOP, [0.2, 0.4], 32)])
def test_filter_design_vs_jax(band, wc, order):
    """numpy in both packages: equal results."""
    b = tfd.fir1(order, wc, band)
    assert np.array_equal(b, jfd.fir1(order, wc, int(band)))
    for t, j in ((tfd.freqz_ba(b, [1.0, -0.5], 256),
                  jfd.freqz_ba(b, [1.0, -0.5], 256)),
                 (tfd.freqz_sos(np.r_[b[:3], 1.0, 0.2, 0.1], 128),
                  jfd.freqz_sos(np.r_[b[:3], 1.0, 0.2, 0.1], 128))):
        for a, c in zip(t, j):
            assert np.array_equal(a, c)
    x = _rand(2, 200)
    assert np.array_equal(tfd.filter_(b, [1.0, -0.3], x),
                          jfd.filter_(b, [1.0, -0.3], x))
    assert np.array_equal(tfd.filtfilt(b, [1.0], x), jfd.filtfilt(b, [1.0], x))
    assert np.array_equal(tfd.smooth1(9), jfd.smooth1(9))
    assert np.array_equal(tfd.mean_filter_coeffs(5),
                          jfd.mean_filter_coeffs(5))


def test_fir1_lowpass_response():
    """tests/test_filter_design.py's response check, through the port."""
    b = tfd.fir1(64, [0.25], aft.dsp.FilterBandType.LOW_PASS)
    H, w = tfd.freqz_ba(b, [1.0], fft_length=512)
    assert abs(np.abs(H)[0] - 1.0) < 1e-3
    assert np.abs(H)[w > 8000].max() < 0.02
