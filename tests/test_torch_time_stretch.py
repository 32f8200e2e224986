"""The port's ``TimeStretch`` and ``PitchShift`` on the CPU
(``device="cpu"``), against the JAX package and the reference C goldens
(``mir2``, the bounds of tests/test_mir2.py).

The phase vocoder sums its phase in float64 in the port and in float32 in
the JAX package (``dsp/phase_vocoder.py``; the vocoder itself is held in
tests/test_torch_dsp.py), so the whole outputs are compared at the
goldens' bounds, and the stages around the vocoder (the STFT, the ISTFT
of one vocoded spectrum, the resampler at each shift's ratio) at 1e-5 of
the peak."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_torch.dsp import phase_vocoder
from tests.conftest import assert_close_to_golden
from tests.test_torch_cqt import _direct_resample

SR = 32000
CPU = {"device": "cpu"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _peak_freq(y, sr):
    w = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    return np.argmax(w) * sr / len(y)


def test_time_stretch_matches_golden_and_jax(goldens):
    g = goldens("mir2")
    ts = aft.TimeStretch(radix2_exp=11, slide_length=512, **CPU)
    tj = af.TimeStretch(radix2_exp=11, slide_length=512)
    for rate, key in ((1.5, "ts_fast"), (0.8, "ts_slow")):
        y = _np(ts.time_stretch(g["in_tone"], rate))
        yj = np.asarray(tj.time_stretch(g["in_tone"], rate))
        assert y.shape == yj.shape
        for ref, what in ((g[key], key), (yj, "jax")):
            n = min(len(y), len(ref))
            assert np.abs(y[:n] - ref[:n]).max() <= 0.09 * np.abs(ref).max(), what
        assert abs(_peak_freq(y, SR) - 220) < 6
    assert ts.cal_data_capacity(1.5, 32000) == tj.cal_data_capacity(1.5, 32000)


def test_time_stretch_stages_match_jax(goldens):
    """The STFT of the input and the ISTFT of one vocoded spectrum against
    JAX's, 1e-5 of the peak; the whole call is that composition."""
    x = goldens("mir2")["in_tone"]
    ts = aft.TimeStretch(radix2_exp=11, slide_length=512, **CPU)
    tj = af.TimeStretch(radix2_exp=11, slide_length=512)
    D = ts._stft.stft(x)
    assert_close_to_golden(_np(D), np.asarray(tj._stft.stft(x)), 1e-5, "stft")
    D2 = phase_vocoder(D, 512, 1.25, **CPU)
    y = _np(ts._stft.istft(D2, method_type=0))
    ref = np.asarray(tj._stft.istft(_np(D2), method_type=0))
    # the edges divide by window-energy sums near the 1e-6 clamp, which
    # amplifies FFT rounding (tests/test_torch_stft.py's bounds)
    N = ts.fft_length
    assert np.abs(y - ref)[N:-N].max() <= 1e-4 * np.abs(ref).max()
    assert_close_to_golden(y, ref, 1e-3, "istft")
    np.testing.assert_array_equal(_np(ts.time_stretch(x, 1.25)), y)


def test_time_stretch_batched():
    rng = np.random.default_rng(4)
    x = (0.5 * np.sin(2 * np.pi * 330 * np.arange(8192) / SR)
         + 0.05 * rng.standard_normal(8192)).astype(np.float32)
    ts = aft.TimeStretch(radix2_exp=11, slide_length=512, **CPU)
    out = _np(ts.time_stretch(np.stack([x, x[::-1].copy()]), 1.25))
    np.testing.assert_allclose(out[0], _np(ts.time_stretch(x, 1.25)),
                               atol=1e-6)
    with pytest.raises(ValueError):
        ts.time_stretch(x, 0.0)


def test_pitch_shift_matches_golden_and_jax(goldens):
    g = goldens("mir2")
    ps = aft.PitchShift(radix2_exp=11, slide_length=512, **CPU)
    y = _np(ps.pitch_shift(g["in_tone"], 5, SR))
    yj = np.asarray(af.PitchShift(radix2_exp=11, slide_length=512)
                    .pitch_shift(g["in_tone"], 5, SR))
    assert y.shape == yj.shape
    for ref in (g["ps_up5"], yj):
        n = min(len(y), len(ref))
        assert np.abs(y[:n] - ref[:n]).max() <= 0.12 * np.abs(ref).max()
    assert abs(_peak_freq(y, SR) - 220 * 2 ** (5 / 12)) < 8


@pytest.mark.parametrize("semitones", [5, 2, -5, 7, -11])
def test_pitch_shift_resampler_matches_jax(goldens, semitones):
    """The resampler at each shift's ratio, including +2 (890/999) and -11
    (1833/971), ratios whose ``limit_denominator(1000)`` has a large
    numerator: the plan's taps equal JAX's, and the output equals the
    float64 polyphase model of tests/test_torch_cqt.py at 1e-5 of the peak
    (JAX's resampler compiles one convolution a phase, too slow here past
    +5's p = 221, where it is compared directly).  The plan is kept per
    (p, q, ratio)."""
    x = goldens("mir2")["in_tone"]
    ps = aft.PitchShift(radix2_exp=11, slide_length=512, **CPU)
    pj = af.PitchShift(radix2_exp=11, slide_length=512)
    rate = 2.0 ** (-semitones / 12.0)
    y = _np(ps._ts.time_stretch(x, rate))
    out = _np(ps.pitch_shift(x, semitones, SR))
    f = Fraction(rate).limit_denominator(1000)
    assert (ps._rs.p, ps._rs.q, ps._rs.ratio) == (f.numerator,
                                                   f.denominator, rate)
    pj._rs.p, pj._rs.q, pj._rs.ratio = f.numerator, f.denominator, rate
    plan = ps._rs._plan()
    assert np.array_equal(plan.filts, pj._rs._plan().filts)
    assert plan.base == pj._rs._plan().base
    if semitones == 5:
        ref = np.asarray(pj._rs.resample(y))
    else:
        ref = (_direct_resample(y[None], plan, out.shape[-1])[0]
               / np.sqrt(rate))
    assert out.shape == ref.shape == (int(np.floor(len(y) * rate)),)
    assert_close_to_golden(out, ref, 1e-5, f"resample {f}")
    assert abs(_peak_freq(out, SR) - 220 * 2 ** (semitones / 12)) < 10
    assert len(ps._rs._plans) == 1


def test_pitch_shift_zero_and_range():
    ps = aft.PitchShift(radix2_exp=11, slide_length=512, **CPU)
    x = np.arange(4096, dtype=np.float32)
    np.testing.assert_array_equal(_np(ps.pitch_shift(x, 0)), x)
    with pytest.raises(ValueError):
        ps.pitch_shift(x, 13)


def test_device_policy():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (aft.TimeStretch, aft.PitchShift):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
