"""The port's batched pitch engines (NCF, CEP, HPS, LHS, PEF) and
HarmonicRatio on the CPU (``device="cpu"``), against the JAX package on
the same seeded inputs and against the reference C goldens (the
tolerances of tests/test_pitch.py and tests/test_mir2.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.ops.frame import frame_signal as j_frame_signal
from audioflux_torch.mir.pitch import autocorr_rows
from audioflux_torch.ops import cuda_fft
from tests.conftest import assert_close_to_golden

SR = 32000
CPU = {"device": "cpu"}
NAMES = ["ncf", "cep", "hps", "lhs", "pef"]
PAIRS = {"ncf": (af.PitchNCF, aft.PitchNCF), "cep": (af.PitchCEP, aft.PitchCEP),
         "hps": (af.PitchHPS, aft.PitchHPS), "lhs": (af.PitchLHS, aft.PitchLHS),
         "pef": (af.PitchPEF, aft.PitchPEF)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def clips():
    """Two 1 s clips: a 196 Hz tone with three overtones and noise, and a
    tone gliding 300 -> 500 Hz with noise (seeded)."""
    rng = np.random.default_rng(5)
    t = np.arange(SR) / SR
    a = sum(0.5 / k * np.sin(2 * np.pi * 196 * k * t + k) for k in range(1, 5))
    b = 0.5 * np.sin(2 * np.pi * (300 * t + 100 * t * t))
    x = np.stack([a, b]) + 0.02 * rng.standard_normal((2, SR))
    return x.astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_pitch_matches_golden_and_jax(goldens, name):
    g = goldens("pitch")
    jcls, tcls = PAIRS[name]
    kw = dict(samplate=SR, radix2_exp=12, slide_length=1024)
    fre = _np(tcls(**kw, **CPU).pitch(g["in_tone"]))
    np.testing.assert_allclose(fre, g[name], atol=1e-3)
    np.testing.assert_allclose(fre, np.asarray(jcls(**kw).pitch(g["in_tone"])),
                               atol=1e-3)


@pytest.mark.parametrize("name", NAMES)
def test_pitch_batched_matches_jax(clips, name):
    """A batch of two seeded clips, frame for frame against JAX, and each
    clip of the batch against the clip alone."""
    jcls, tcls = PAIRS[name]
    kw = dict(samplate=SR, radix2_exp=12, slide_length=512)
    plan = tcls(**kw, **CPU)
    fre = _np(plan.pitch(clips))
    assert fre.shape == (2, plan.cal_time_length(SR))
    np.testing.assert_allclose(fre, np.asarray(jcls(**kw).pitch(clips)),
                               atol=1e-3)
    np.testing.assert_allclose(fre[1], _np(plan.pitch(clips[1])), atol=1e-3)


@pytest.mark.parametrize("name", ["ncf", "hps", "pef"])
def test_pitch_options_match_jax(clips, name):
    """Non-default options: a band, another radix, a HANN window (NCF's
    default is RECT, the others' HAMM), PEF's filter parameters."""
    jcls, tcls = PAIRS[name]
    kw = dict(samplate=SR, low_fre=60.0, high_fre=1000.0, radix2_exp=11,
              slide_length=700, window_type=af.WindowType.HANN)
    tp, jp = tcls(**kw, **CPU), jcls(**kw)
    if name == "pef":
        tp.set_filter_params(8.0, 0.3, 1.5)
        jp.set_filter_params(8.0, 0.3, 1.5)
        assert tp.xcorr_fft_length == jp.xcorr_fft_length
    np.testing.assert_allclose(_np(tp.pitch(clips)),
                               np.asarray(jp.pitch(clips)), atol=1e-3)


def test_plan_constants_match_jax():
    """The index ranges, gathers and PEF's grids and filter equal JAX's;
    PEF's cross-correlation at the defaults runs at 2^(12+3) = 32768."""
    kw = dict(samplate=SR, radix2_exp=12, slide_length=1024)
    for name in NAMES:
        j, t = PAIRS[name][0](**kw), PAIRS[name][1](**kw, **CPU)
        assert (t.min_index, t.max_index) == (j.min_index, j.max_index)
    j, t = af.PitchHPS(**kw), aft.PitchHPS(**kw, **CPU)
    assert t.interp_fft_length == j.interp_fft_length == 32768
    np.testing.assert_array_equal(t._hidx, j._hidx)
    j, t = af.PitchPEF(**kw), aft.PitchPEF(**kw, **CPU)
    assert t._pad_num == j._pad_num > 0
    assert t.xcorr_fft_length == j.xcorr_fft_length == 32768
    np.testing.assert_array_equal(t._filter, j._filter)
    np.testing.assert_array_equal(t._log_fre, j._log_fre)
    np.testing.assert_array_equal(t._band_width, j._band_width)


@pytest.mark.parametrize("n,L", [(8192, 4096), (4096, 2048), (8192, 3000)])
def test_autocorr_rows_matches_jax_power_inverse(clips, n, L):
    """NCF's and HarmonicRatio's autocorrelation through
    ``fft_autocorr_ref`` (the kernel's plain version) against JAX's
    ``real(ifft(|fft(frame, n)|^2))``, at 1e-5 of the peak."""
    frames = np.ascontiguousarray(
        np.array(j_frame_signal(jnp.asarray(clips), L, 997)))
    Fj = jnp.fft.fft(jnp.asarray(frames), n=n, axis=-1)
    ref = np.asarray(jnp.real(jnp.fft.ifft(jnp.abs(Fj) ** 2, axis=-1)))
    before = cuda_fft.fft_autocorr.launches
    got = _np(autocorr_rows(torch.from_numpy(frames), n))
    assert cuda_fft.fft_autocorr.launches == before  # the CPU's plain version
    assert got.shape == ref.shape
    assert_close_to_golden(got, ref, 1e-5, "autocorrelation")


def test_ncf_and_hr_reach_the_autocorrelation_wrapper(clips, monkeypatch):
    """NCF and HarmonicRatio call ``cuda_fft.fft_autocorr_frames`` once,
    at 2 x window (8192 at the defaults), with their (windowed) frames,
    and ask only for the lags they read: NCF's up to ``max_index``,
    HarmonicRatio's up to ``max_length``."""
    seen = []
    real = cuda_fft.fft_autocorr_frames

    def spy(frames, n, lags):
        seen.append((tuple(frames.shape), n, lags))
        return real(frames, n, lags)
    monkeypatch.setattr(cuda_fft, "fft_autocorr_frames", spy)
    ncf, hr = aft.PitchNCF(**CPU), aft.HarmonicRatio(**CPU)
    ncf.pitch(clips)
    hr.harmonic_ratio(clips)
    T_ncf = ncf.cal_time_length(SR)
    T_hr = hr.cal_time_length(SR)
    assert seen == [((2, T_ncf, 4096), 8192, ncf.max_index + 1),
                    ((2, T_hr, 4096), 8192, hr.max_length + 1)]


def test_harmonic_ratio_matches_golden_and_jax(goldens):
    g = goldens("mir2")
    kw = dict(samplate=SR, radix2_exp=12, slide_length=512)
    out = _np(aft.HarmonicRatio(**kw, **CPU).harmonic_ratio(g["in_tone"]))
    assert_close_to_golden(out, g["hr"], 5e-5, "hr")
    ref = np.asarray(af.HarmonicRatio(**kw).harmonic_ratio(g["in_tone"]))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(radix2_exp=12, slide_length=1024),
                                dict(radix2_exp=11, slide_length=300,
                                     low_fre=80.0),
                                dict(radix2_exp=12, low_fre=-1.0,
                                     window_type=af.WindowType.HANN)])
def test_harmonic_ratio_batched_matches_jax(clips, kw):
    kw = dict(samplate=SR, **kw)
    t, j = aft.HarmonicRatio(**kw, **CPU), af.HarmonicRatio(**kw)
    assert (t.max_length, t.low_fre) == (j.max_length, j.low_fre)
    out = _np(t.harmonic_ratio(clips))
    np.testing.assert_allclose(out, np.asarray(j.harmonic_ratio(clips)),
                               atol=1e-5, rtol=0)
    assert out.shape == (2, t.cal_time_length(SR))


def test_device_policy():
    """``device=None`` is the card; with none, every new plan raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (aft.PitchNCF, aft.PitchCEP, aft.PitchHPS, aft.PitchLHS,
                aft.PitchPEF, aft.HarmonicRatio):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


@pytest.mark.parametrize("n", [1000, 4096, 32768])
def test_fft_parts_and_real_inverse(n):
    """``ops.fft.fft_parts`` (real and complex input) and
    ``ifft_parts(real_only=True)``, which HPS, LHS and PEF call, against
    ``torch.fft`` at a kernel length and one outside the kernel tier."""
    from audioflux_torch.ops import fft as afft
    rng = np.random.default_rng(n)
    a, b = (torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
            for _ in range(2))
    for got, ref in ((afft.fft_parts(a), torch.fft.fft(a)),
                     (afft.fft_parts(a, b), torch.fft.fft(torch.complex(a, b)))):
        for g, r in zip(got, (ref.real, ref.imag)):
            assert_close_to_golden(_np(g), _np(r), 1e-6, "fft_parts")
    real = afft.ifft_parts(a, b, real_only=True)
    assert not real.is_complex()
    assert_close_to_golden(_np(real), _np(torch.fft.ifft(torch.complex(a, b))
                                          .real), 1e-6, "ifft_parts real")
