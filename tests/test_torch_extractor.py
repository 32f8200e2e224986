"""The port's ``FeatureExtractor`` on the CPU (``device="cpu"``): all nine
transforms, then ``spectral``, ``xxcc`` and ``deconv`` over every result,
against the JAX extractor on the CPU on the same seeded inputs and against
the reference facade's goldens (tests/test_fuzz_goldens.py's tolerances);
which of the new paths reach the FFT kernel tier (``ops.cuda_fft``) at
4096; and the device policy of every plan and one-shot of this slice.

Tolerances against the JAX extractor, of the peak: the spectrograms 2e-6
(the same float32 transforms); ``spectral(flux)`` 1e-6 of num * peak^2,
the scale of its summed squared differences (some transforms' flux is
cancellation noise at 1e-15); ``xxcc`` 1e-4 (log10 of cells down at its
1e-8 floor); ``deconv``'s timbre 2e-6 and pitch 1e-4 (the whitening
F / |F| amplifies near-zero bins; the golden tests allow 5e-4)."""

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_torch import spectrogram as legacy
from audioflux_torch.ops import cuda_fft
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}
NAMES = ["bft", "nsgt", "cwt", "pwt", "cqt", "st", "fst", "dwt", "wpt"]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol, label="", scale=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-20) if scale is None else scale
    err = np.max(np.abs(got - ref))
    assert err <= tol * scale, f"{label}: rel err {err / scale:.3e} > {tol}"


@pytest.fixture(scope="module")
def extracted():
    """Both extractors over two clips of 2**10 samples (a tone with noise,
    and noise), eight bands where the extractor takes ``num``."""
    rng = np.random.default_rng(11)
    t = np.arange(1024) / 32000
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t)
                  + 0.05 * rng.standard_normal(1024),
                  0.3 * rng.standard_normal(1024)]).astype(np.float32)
    fe = aft.FeatureExtractor(NAMES, num=8, radix2_exp=10, **CPU)
    je = af.FeatureExtractor(NAMES, num=8, radix2_exp=10)
    return fe, je, fe.spectrogram(x), je.spectrogram(x)


@pytest.mark.parametrize("name", NAMES)
def test_spectrogram_vs_jax(extracted, name):
    fe, je, got, ref = extracted
    out = got[name]["spectrogram"]
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert got[name].name == name
    _close(out, ref[name]["spectrogram"], 2e-6, name)


@pytest.mark.parametrize("name", NAMES)
def test_spectral_xxcc_deconv_vs_jax(extracted, name):
    fe, je, got, ref = extracted
    one, jone = {name: got[name]}, {name: ref[name]}
    spec = np.abs(np.asarray(ref[name]["spectrogram"]))
    flux = fe.spectral(one, "flux")[name]["flux"]
    assert flux.device.type == "cpu"
    _close(flux, je.spectral(jone, "flux")[name]["flux"], 1e-6, "flux",
           scale=spec.shape[-2] * spec.max() ** 2)
    _close(fe.spectral(one, "centroid")[name]["centroid"],
           je.spectral(jone, "centroid")[name]["centroid"], 1e-5, "centroid")
    _close(fe.xxcc(one, 8)[name]["xxcc"], je.xxcc(jone, 8)[name]["xxcc"],
           1e-4, "xxcc")
    d, jd = fe.deconv(one)[name], je.deconv(jone)[name]
    _close(d["timbre"], jd["timbre"], 2e-6, "timbre")
    _close(d["pitch"], jd["pitch"], 1e-4, "pitch")


def test_extractor_pads_and_cuts_fixed_length_transforms():
    """Clips shorter than 2**radix2_exp are zero-padded, longer ones cut,
    for the fixed-length transforms (ST, DWT), as in the JAX extractor;
    BFT takes the whole clip."""
    rng = np.random.default_rng(12)
    for n, names in ((700, ["st", "dwt"]), (3000, ["st", "dwt", "bft"])):
        fe = aft.FeatureExtractor(names, num=6, radix2_exp=10, **CPU)
        je = af.FeatureExtractor(names, num=6, radix2_exp=10)
        x = rng.standard_normal(n).astype(np.float32)
        got, ref = fe.spectrogram(x), je.spectrogram(x)
        for name in names:
            _close(got[name]["spectrogram"], ref[name]["spectrogram"], 2e-6,
                   f"{name} n={n}")
    with pytest.raises(ValueError, match="unsupported transform"):
        aft.FeatureExtractor(["stft"], **CPU)
    assert aft.FeatureExtractor("st", radix2_exp=10, **CPU).transforms == [
        "st"]


def test_fuzz_extractor_golden(goldens, signals):
    """tests/test_fuzz_goldens.py's facade case through the port."""
    g = goldens("fuzz_extractor")
    x = signals["sine"][:8192]
    fe = aft.FeatureExtractor(transforms=["bft", "cwt", "pwt"], num=64,
                              radix2_exp=11, samplate=32000, slide_length=512,
                              scale_type=aft.SpectralFilterBankScaleType.MEL,
                              **CPU)
    spec_res = fe.spectrogram(x)
    for name in ("bft", "cwt", "pwt"):
        arr = _np(spec_res[name]["spectrogram"])
        ref = (g[f"{name}_re"] + 1j * g[f"{name}_im"])[0]
        assert_close_to_golden(arr.real, ref.real, 5e-4, f"fe_{name}_re")
        assert_close_to_golden(arr.imag, ref.imag, 5e-4, f"fe_{name}_im")
    sp = fe.spectral(spec_res, spectral="flux")
    cc = fe.xxcc(spec_res, cc_num=13)
    for name in ("bft", "cwt", "pwt"):
        assert_close_to_golden(_np(sp[name]["flux"]), g[f"{name}_flux"][0],
                               5e-4, f"fe_{name}_flux")
        assert_close_to_golden(_np(cc[name]["xxcc"]), g[f"{name}_cc"][0],
                               5e-4, f"fe_{name}_cc")


def _counting(monkeypatch):
    """Count the calls ``ops.fft`` makes into the kernel wrappers (on the
    CPU they run their plain versions; ``.launches`` counts only the
    card's launches)."""
    calls = {"fft_fwd": 0, "fft_inv": 0}
    for name in calls:
        fn = getattr(cuda_fft, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(cuda_fft, name, wrapped)
    return calls


def test_new_paths_reach_the_kernel_tier_at_4096(monkeypatch):
    """ST, FST, NSGT, Deep, Xcorr, Hilbert and CZT on clips of 4096 samples
    go through the FFT kernels' wrappers (forward; ST and the DSP calls
    also the inverse); Cepstrogram pins torch.fft and goes through
    neither."""
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, 4096)).astype(np.float32)
    long = rng.standard_normal((1, 8192)).astype(np.float32) * 30
    runs = {
        "ST": (lambda: aft.ST(radix2_exp=12, **CPU).st(x), (1, 1)),
        "FST": (lambda: aft.FST(radix2_exp=12, **CPU).fst(x), (1, 0)),
        "NSGT": (lambda: aft.NSGT(radix2_exp=12, **CPU).nsgt(x), (1, 0)),
        "Deep": (lambda: aft.DeepSpectrogram(radix2_exp=12, **CPU)
                 .spectrogram(long), (1, 0)),
        "Xcorr": (lambda: aft.xcorr(x, x[::-1].copy(), **CPU), (2, 1)),
        "Hilbert": (lambda: aft.hilbert(x, **CPU), (1, 1)),
        "CZT": (lambda: aft.czt(x, 0.1, 0.2, **CPU), (1, 1)),
        "Cepstrogram": (lambda: aft.Cepstrogram(radix2_exp=12, **CPU)
                        .cepstrogram(long), (0, 0)),
    }
    for name, (run, want) in runs.items():
        calls.update(fft_fwd=0, fft_inv=0)
        run()
        assert (calls["fft_fwd"], calls["fft_inv"]) == want, (name, calls)


_PLANS = [
    ("ST", lambda **d: aft.ST(radix2_exp=10, **d)),
    ("FST", lambda **d: aft.FST(radix2_exp=10, **d)),
    ("NSGT", lambda **d: aft.NSGT(num=16, radix2_exp=10, **d)),
    ("DWT", lambda **d: aft.DWT(radix2_exp=10, **d)),
    ("WPT", lambda **d: aft.WPT(num=3, radix2_exp=10, **d)),
    ("SWT", lambda **d: aft.SWT(2, 1024, **d)),
    ("Cepstrogram", lambda **d: aft.Cepstrogram(radix2_exp=10, **d)),
    ("DeepSpectrogram", lambda **d: aft.DeepSpectrogram(radix2_exp=10, **d)),
    ("DeepChromaSpectrogram",
     lambda **d: aft.DeepChromaSpectrogram(radix2_exp=10, **d)),
    ("FeatureExtractor",
     lambda **d: aft.FeatureExtractor(["st", "dwt"], radix2_exp=10, **d)),
    ("CZT", lambda **d: aft.CZT(10, **d)),
    ("Hilbert", lambda **d: aft.Hilbert(10, **d)),
    ("Xcorr", lambda **d: aft.Xcorr(**d)),
    ("DCT", lambda **d: aft.DCT(64, **d)),
    ("legacy Mel", lambda **d: legacy.Mel(radix2_exp=10, **d)),
]
_ONE_SHOTS = [
    ("czt", lambda x, **d: aft.czt(x, 0.1, 0.2, **d)),
    ("xcorr", lambda x, **d: aft.xcorr(x, **d)[0]),
    ("hilbert", lambda x, **d: aft.hilbert(x, **d)),
    ("dct", lambda x, **d: aft.dct(x, **d)),
    ("idct", lambda x, **d: aft.idct(x, **d)),
    ("conv", lambda x, **d: aft.dsp.conv(x, x[:5], **d)),
    ("phase_vocoder", lambda x, **d: aft.phase_vocoder(
        x.reshape(16, 64).astype(np.complex64), 256, 1.5, **d)),
]


def test_device_policy_of_the_new_plans(monkeypatch):
    """``device=None`` means cuda and raises without it; ``device="cpu"``
    runs and keeps its results on the CPU; a plan refuses a tensor on
    another device."""
    x = np.random.default_rng(14).standard_normal(1024).astype(np.float32)
    for name, make in _PLANS:
        assert make(**CPU).device == torch.device("cpu"), name
    for name, fn in _ONE_SHOTS:
        out = fn(x, **CPU)
        assert out.device.type == "cpu" and bool(
            torch.isfinite(out).all()), name
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for name, make in _PLANS:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        for name, fn in _ONE_SHOTS:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(x)
    with pytest.raises(ValueError):
        aft.ST(radix2_exp=10, **CPU).st(torch.zeros(1024, device="meta"))


def test_exports_match_the_jax_package():
    """The names the JAX package exports for this slice's modules, at the
    top level and from ``dsp``, exist in the port too."""
    import audioflux_tpu.dsp as jdsp
    top = ["DeepSpectrogram", "DeepChromaSpectrogram", "NSGT",
           "NSGTFilterBankType", "ST", "FST", "DWT", "WPT", "SWT",
           "Cepstrogram", "FeatureExtractor", "FeatureResult", "CZT", "czt",
           "Xcorr", "XcorrNormalType", "xcorr", "Hilbert", "hilbert", "DCT",
           "dct", "idct", "phase_vocoder", "WaveletDiscreteType"]
    for name in top:
        assert hasattr(af, name) and hasattr(aft, name), name
    dsp_names = [n for n in dir(jdsp) if not n.startswith("_")
                 and callable(getattr(jdsp, n))]
    missing = [n for n in dsp_names if not hasattr(aft.dsp, n)]
    assert not missing, missing
