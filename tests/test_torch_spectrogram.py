"""The port's spectrogram slice end to end, on the CPU (``device="cpu"``),
against the JAX package on the CPU (1e-4 of the peak) and against the
reference C goldens (the tolerances of tests/test_spectrogram.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.types import (CepstralEnergyType, CepstralRectifyType,
                                 ChromaDataNormalType, SpectralDataType,
                                 SpectralFilterBankNormalType as NT,
                                 SpectralFilterBankScaleType as S,
                                 SpectralFilterBankStyleType as ST,
                                 WindowType)
from tests.conftest import assert_close_to_golden

SR, R2E, SLIDE = 32000, 11, 512
CPU = {"device": "cpu"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=1e-4, label=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    err = np.max(np.abs(got - ref)) if got.size else 0.0
    assert err <= tol * max(np.max(np.abs(ref)) if ref.size else 0.0, 1e-20), (
        f"{label}: rel err {err / np.max(np.abs(ref)):.3e}")


def _pair(cls_name, **kw):
    """(JAX plan, port plan) of the same class and arguments."""
    return (getattr(af, cls_name)(**kw),
            getattr(aft, cls_name)(**kw, **CPU))


# (name, class, kwargs, signal, golden file, golden key, golden tolerance)
_CASES = [
    ("mel", "MelSpectrogram", dict(num=128), "sine",
     "spectrogram", "mel_spec", 5e-5),
    ("bark", "BarkSpectrogram", dict(num=64), "sine",
     "spectrogram", "bark_spec", 5e-5),
    ("erb", "ErbSpectrogram", dict(num=64), "sine",
     "spectrogram", "erb_spec", 5e-5),
    ("gammatone", "Spectrogram", dict(num=64, filter_bank_type=S.ERB,
                                      style_type=ST.GAMMATONE), "sine",
     "spectrogram", "gamma_spec", 5e-5),
    ("linear", "Spectrogram", dict(filter_bank_type=S.LINEAR), "sine",
     "spectrogram", "linear_spec", 5e-5),
    ("linear_sub", "Spectrogram", dict(filter_bank_type=S.LINEAR,
                                       low_fre=100.0, high_fre=8000.0),
     "sine", "spectrogram", "linear_sub_spec", 5e-5),
    ("octave", "Spectrogram", dict(num=84, filter_bank_type=S.OCTAVE),
     "chirp", "spectrogram", "octave_spec", 5e-5),
    ("mel_mag", "MelSpectrogram", dict(num=128,
                                       data_type=SpectralDataType.MAG),
     "sine", "spectrogram", "mel_mag_spec", 5e-5),
    ("chroma", "Spectrogram", dict(num=12, filter_bank_type=S.CHROMA),
     "chord", "chroma", "chroma_spec", 2e-4),
    ("chroma_sub", "Spectrogram", dict(num=12, filter_bank_type=S.CHROMA,
                                       low_fre=100.0, high_fre=6000.0),
     "chord", None, None, None),
    ("log_chroma", "Spectrogram", dict(num=12, filter_bank_type=S.LOG_CHROMA),
     "chord", None, None, None),
    ("log_area", "Spectrogram", dict(num=48, filter_bank_type=S.LOG,
                                     normal_type=NT.AREA), "chirp",
     None, None, None),
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c[0])
def test_spectrogram_matches_jax_and_golden(case, goldens, signals):
    name, cls, kw, sig, gfile, gkey, gtol = case
    j, t = _pair(cls, samplate=SR, radix2_exp=R2E, slide_length=SLIDE, **kw)
    x = signals[sig]
    spec = t.spectrogram(x)
    _close(spec, j.spectrogram(x), 1e-4, name)
    assert np.array_equal(t.get_fre_band_arr(), j.get_fre_band_arr())
    if gfile is not None:
        assert_close_to_golden(_np(spec), goldens(gfile)[gkey], gtol, gkey)


def test_cepstral_family(goldens, signals):
    g = goldens("spectrogram")
    x = signals["sine"]
    for cls, kw, method, key, atol in (
            ("MelSpectrogram", dict(num=128), "mfcc", "mel_mfcc", 2e-4),
            ("BarkSpectrogram", dict(num=64), "bfcc", "bark_bfcc", 2e-4),
            ("Spectrogram", dict(num=64, filter_bank_type=S.ERB,
                                 style_type=ST.GAMMATONE), "gtcc",
             "gamma_gtcc", 3e-4)):
        j, t = _pair(cls, samplate=SR, radix2_exp=R2E, slide_length=SLIDE,
                     **kw)
        spec = j.spectrogram(x)
        got = getattr(t, method)(np.asarray(spec), cc_num=13)
        _close(got, getattr(j, method)(spec, cc_num=13), 1e-4, method)
        np.testing.assert_allclose(_np(got), g[key], atol=atol)
    j, t = _pair("Spectrogram", samplate=SR, radix2_exp=R2E,
                 slide_length=SLIDE, filter_bank_type=S.LINEAR)
    spec = np.asarray(j.spectrogram(x))
    _close(t.lfcc(spec, cc_num=20), j.lfcc(spec, cc_num=20), 1e-4, "lfcc")
    for rect in CepstralRectifyType:
        _close(t.xxcc(spec, 13, rect), j.xxcc(spec, 13, rect), 1e-4,
               rect.name)
    with pytest.raises(ValueError):
        t.mfcc(spec)


def test_xxcc_standard(signals):
    j_plan = af.MelSpectrogram(num=64, samplate=SR, radix2_exp=R2E,
                               slide_length=SLIDE)
    spec = np.asarray(j_plan.spectrogram(signals["sine"]))
    energy = spec.sum(axis=0)
    j, t = af.XXCC(64), aft.XXCC(64, **CPU)
    for et in CepstralEnergyType:
        for dw in (9, 4):
            got = t.xxcc_standard(spec, energy, 13, dw, et)
            ref = j.xxcc_standard(spec, energy, 13, dw, et)
            for a, b, what in zip(got, ref, ("coe", "d1", "d2")):
                _close(a, b, 1e-4, f"{et.name}/{dw}/{what}")
    _close(t.xxcc(spec, 13, CepstralRectifyType.CUBIC_ROOT),
           j.xxcc(spec, 13, CepstralRectifyType.CUBIC_ROOT), 1e-4, "cbrt")


@pytest.mark.parametrize("n_frames", [1, 5, 8, 37])
def test_spectrogram_mfcc_fused_routes(n_frames):
    """Every frame count runs the fused kernel's route; against the JAX
    exact path (and, at T < 8, the JAX package's small-T route)."""
    j, t = _pair("MelSpectrogram", num=128, samplate=SR, radix2_exp=R2E,
                 slide_length=SLIDE)
    x = (np.random.default_rng(n_frames).standard_normal(
        (2, (n_frames - 1) * SLIDE + 2048)) * 0.2).astype(np.float32)
    mel, cc = t.spectrogram_mfcc_fused(x, cc_num=13)
    mel_ref = j.spectrogram(x)
    _close(mel, mel_ref, 1e-4, "mel")
    _close(cc, j.xxcc(mel_ref, 13), 1e-4, "cc")
    if n_frames < 8:
        mel_j, cc_j = j.spectrogram_mfcc_fused(x, cc_num=13)
        _close(mel, mel_j, 1e-4, "mel small-T")
        _close(cc, cc_j, 1e-4, "cc small-T")
    assert list(t._fused_cache) == [13]


def test_fused_rejections_and_norm_value(signals):
    j, t = _pair("MelSpectrogram", num=64, samplate=SR, radix2_exp=R2E,
                 slide_length=SLIDE)
    x = signals["short"]
    for plan in (j, t):
        plan.set_data_norm_value(0.5)
    _close(t.spectrogram(x), j.spectrogram(x), 1e-4, "norm 0.5")
    for plan in (j, t):
        with pytest.raises(ValueError):
            plan.spectrogram_mfcc_fused(x)
    jc, tc = _pair("Spectrogram", num=12, samplate=SR, radix2_exp=R2E,
                   slide_length=SLIDE, filter_bank_type=S.CHROMA)
    with pytest.raises(ValueError):
        tc.spectrogram_mfcc_fused(x)
    for norm in ChromaDataNormalType:
        for plan in (jc, tc):
            plan.set_chroma_data_normal_type(norm)
        _close(tc.spectrogram(signals["chord"]),
               jc.spectrogram(signals["chord"]), 1e-4, norm.name)


def test_mag_norm_value_linear_and_mel(signals):
    x = signals["sine"]
    for cls, kw in (("Spectrogram", dict(filter_bank_type=S.LINEAR)),
                    ("MelSpectrogram", dict(num=32))):
        j, t = _pair(cls, samplate=SR, radix2_exp=10, slide_length=256,
                     data_type=SpectralDataType.MAG,
                     window_type=WindowType.HAMM, **kw)
        for plan in (j, t):
            plan.set_data_norm_value(2.0)
        _close(t.spectrogram(x), j.spectrogram(x), 1e-4, cls)


def test_streaming_is_continue(signals):
    """is_continue carries the tail across 3 calls, as the JAX plan does."""
    j, t = _pair("MelSpectrogram", num=64, samplate=SR, radix2_exp=R2E,
                 slide_length=SLIDE, is_continue=True)
    x = signals["sine"]
    for chunk in (x[:1000], x[1000:9000], x[9000:20000]):
        assert t.cal_time_length(len(chunk)) == j.cal_time_length(len(chunk))
        _close(t.spectrogram(chunk), j.spectrogram(chunk), 1e-4, "stream")
    # slide > fft: the carry goes negative and skips samples
    j, t = _pair("MelSpectrogram", num=32, samplate=SR, radix2_exp=10,
                 slide_length=1536, is_continue=True)
    for chunk in (x[:3000], x[3000:4000], x[4000:9000]):
        _close(t.spectrogram(chunk), j.spectrogram(chunk), 1e-4, "skip")


def test_batched_and_core_one_shots(signals):
    x = signals["sine"]
    batch = np.stack([x, x * 0.5])
    for name in ("mel_spectrogram", "bark_spectrogram", "erb_spectrogram"):
        kw = dict(num=48, radix2_exp=R2E, samplate=SR, slide_length=SLIDE)
        spec_t, fre_t = getattr(aft, name)(batch, **kw, **CPU)
        spec_j, fre_j = getattr(af, name)(batch, **kw)
        _close(spec_t, spec_j, 1e-4, name)
        assert np.array_equal(fre_t, fre_j)
        assert getattr(aft, name)(batch, **kw, **CPU)[0].shape == spec_t.shape


def test_load_reference_constants_round_trip(signals):
    j, t = _pair("Spectrogram", num=12, samplate=SR, radix2_exp=R2E,
                 slide_length=SLIDE, filter_bank_type=S.LOG_CHROMA)
    for name in ("window", "filter_bank", "_dct", "chroma_filter_bank"):
        assert np.array_equal(getattr(t, name), getattr(j, name)), name
    # install perturbed JAX constants: the port must follow them
    rng = np.random.default_rng(3)
    fb = (j.filter_bank * (1 + 0.1 * rng.random(j.filter_bank.shape))
          ).astype(np.float32)
    aft.load_reference_constants(t, window=j.window, filter_bank=fb,
                                 dct=j._dct,
                                 chroma_filter_bank=j.chroma_filter_bank)
    j.filter_bank = fb
    j._build_exec()
    _close(t.spectrogram(signals["chord"]), j.spectrogram(signals["chord"]),
           1e-4, "perturbed")
    with pytest.raises(ValueError):
        aft.load_reference_constants(t, window=j.window[:-1],
                                     filter_bank=j.filter_bank, dct=j._dct)


def test_plan_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aft.MelSpectrogram(num=32)
    with pytest.raises(RuntimeError):
        aft.XXCC(13)
    with pytest.raises(RuntimeError):
        aft.mel_spectrogram(np.zeros(4096, np.float32), num=32)
    # a CPU plan refuses a CUDA-resident input rather than copying it
    t = aft.MelSpectrogram(num=32, radix2_exp=R2E, **CPU)
    assert t.device == torch.device("cpu")
    with pytest.raises(ValueError):
        t.spectrogram(torch.zeros(4096, device="meta"))


def test_port_imports_no_jax():
    code = ("import sys; import audioflux_torch; "
            "import audioflux_torch.transforms.spectrogram; "
            "import audioflux_torch.ops.fused_mel, audioflux_torch.core; "
            "import audioflux_torch.transforms.stft, audioflux_torch.mir; "
            "import audioflux_torch.mir.hpss, audioflux_torch.mir.pitch_yin; "
            "import audioflux_torch.ops.pad, audioflux_torch.ops.filter; "
            "import audioflux_torch.ops.cuda_fft; "
            "import audioflux_torch.ops.cuda_median; "
            "import audioflux_torch.convert, audioflux_torch.ops.fft; "
            "from audioflux_torch import (STFT, StreamingSTFT, stft, istft, "
            "HPSS, PitchYIN); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'audioflux_tpu', "
            "'ml_dtypes'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
