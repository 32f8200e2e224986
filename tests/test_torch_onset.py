"""The port's onset stage on the CPU (``device="cpu"``): ``Spectral``,
``Deconv``, the ``Spectrogram`` feature surface and ``Onset``, against the
JAX package on the CPU (1e-4 of the peak; counts and band picks equal) and
against the reference C goldens (tests/test_spectral.py's and
tests/test_fuzz_goldens.py's tolerances)."""

import json

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.mir import onset as jo
from audioflux_tpu.types import (NoveltyType,
                                 SpectralDataType,
                                 SpectralFilterBankScaleType as S,
                                 SpectralNoveltyDataType as ND,
                                 SpectralNoveltyMethodType as NM)
from audioflux_torch.mir import onset as to
from tests.conftest import assert_close_to_golden

SR = 32000
CPU = {"device": "cpu"}

# the features of tests/test_spectral.py and their golden tolerances
_SIMPLE = {
    "flatness": 1e-3, "flux": 2e-4, "rolloff": 2e-4, "centroid": 2e-4,
    "spread": 2e-4, "skewness": 2e-3, "kurtosis": 2e-3, "entropy": 2e-4,
    "crest": 2e-4, "slope": 1e-3, "decrease": 2e-4, "band_width": 2e-4,
    "rms": 2e-4, "energy": 2e-4, "hfc": 2e-4, "sd": 2e-4, "sf": 2e-4,
    "mkl": 2e-4, "broadband": 2e-4, "novelty": 2e-4, "eef": 2e-4,
    "eer": 2e-4,
}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=1e-4, label=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    peak = max(np.max(np.abs(ref)), 1e-20)
    err = np.max(np.abs(got - ref))
    assert err <= tol * peak, f"{label}: rel err {err / peak:.3e} > {tol}"


@pytest.fixture(scope="module")
def spectral_pair(goldens):
    g = goldens("spectral")
    return (af.Spectral(num=128, fre_band_arr=g["in_fre"]),
            aft.Spectral(num=128, fre_band_arr=g["in_fre"], **CPU), g)


def _skewness_scale(spec, fre):
    """The scale of the terms that skewness' third moment sums:
    sum(|f-c|^3 x) / (spread^3 sum(x)), per frame, in float64."""
    x, f = spec.T.astype(np.float64), fre.astype(np.float64)
    s = x.sum(-1)
    d = f - (f * x).sum(-1)[:, None] / s[:, None]
    spread = np.sqrt((d * d * x).sum(-1) / s)
    return (np.abs(d) ** 3 * x).sum(-1) / (spread ** 3 * s)


@pytest.mark.parametrize("name", sorted(_SIMPLE))
def test_spectral_feature(name, spectral_pair):
    j, t, g = spectral_pair
    spec = g["in_spec"]
    got = getattr(t, name)(spec)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    if name == "skewness":
        # this input is near symmetric: its third moment cancels to 3e-4
        # of its terms, and the order of a float32 sum moves the result
        # by 2% (the float64 value lies 1.5% from the golden, which the
        # C's sequential sum made).  The error is held against the scale
        # of the terms, as tests/test_fuzz_goldens.py holds band_width
        # p=1, at the tolerance the others take against the peak.
        scale = _skewness_scale(spec, g["in_fre"])
        for ref in (np.asarray(j.skewness(spec)), g[name]):
            assert np.all(np.abs(_np(got) - ref) <= 1e-4 * scale)
    else:
        _close(got, getattr(j, name)(spec), 1e-4, name)
        assert_close_to_golden(_np(got), g[name], _SIMPLE[name], name)
    # a batch of two clips gives each clip's own result
    batch = getattr(t, name)(np.stack([spec, 0.5 * spec]))
    _close(batch[0], got, 1e-6, f"{name} batched")


def test_spectral_variants_and_statistics(spectral_pair):
    j, t, g = spectral_pair
    spec = g["in_spec"]
    for label, fn, key in (
            ("flux", lambda o: o.flux(spec, step=2, p=2, is_positive=True,
                                      is_exp=True, tp=1),
             "flux_pos_exp_mean"),
            ("flux p=3", lambda o: o.flux(spec, step=3, p=3), None),
            ("entropy", lambda o: o.entropy(spec, is_norm=True),
             "entropy_norm"),
            ("energy", lambda o: o.energy(spec, is_log=True, gamma=10.0),
             "energy_log"),
            ("mkl tp", lambda o: o.mkl(spec, tp=1), None),
            ("broadband", lambda o: o.broadband(spec, threshold=3.0), None)):
        got = fn(t)
        _close(got, fn(j), 1e-4, label)
        if key is not None:
            assert_close_to_golden(_np(got), g[key], 2e-4, key)
    # band_width at p=1 is sum(x (f - c)), zero by the centroid's
    # definition: both sides are float32 cancellation noise, held against
    # the cancellation scale as tests/test_fuzz_goldens.py holds it
    x, f = spec.T.astype(np.float64), g["in_fre"].astype(np.float64)
    c = (f * x).sum(-1) / x.sum(-1)
    cancel = (x * np.abs(f - c[:, None])).sum(-1)
    got = _np(t.band_width(spec, p=1))
    for ref in (np.asarray(j.band_width(spec, p=1)), g["band_width_p1"]):
        assert np.all(np.abs(got - ref) <= 1e-4 * cancel + 1e-6)
    for mt in NM:
        for dt in ND:
            got = t.novelty(spec, step=2, threshold=0.01, method_type=mt,
                            data_type=dt)
            _close(got, j.novelty(spec, step=2, threshold=0.01,
                                  method_type=mt, data_type=dt), 1e-4,
                   f"novelty {mt.name}/{dt.name}")
    assert_close_to_golden(
        _np(t.novelty(spec, method_type=NM.KL, data_type=ND.NUMBER)),
        g["novelty_kl_num"], 1e-6, "novelty_kl_num")
    for name, tols in (("max", (2e-4, 1e-6)), ("mean", (2e-4, 1e-5)),
                       ("var", (2e-4, 1e-5))):
        got, ref = getattr(t, name)(spec), getattr(j, name)(spec)
        for a, b, what, tol in zip(got, ref, ("v", "f"), tols):
            _close(a, b, 1e-5, f"{name}_{what}")
            assert_close_to_golden(_np(a), g[f"{name}_{what}"], tol, name)


def test_spectral_edges(spectral_pair):
    j, t, g = spectral_pair
    spec = g["in_spec"]
    j2 = af.Spectral(num=128, fre_band_arr=g["in_fre"])
    t2 = aft.Spectral(num=128, fre_band_arr=g["in_fre"], **CPU)
    for plan in (j2, t2):
        plan.set_edge(10, 99)
    for name, tol in (("centroid", 2e-4), ("hfc", 2e-4),
                      ("decrease", 2e-3), ("rms", 2e-4)):
        got = getattr(t2, name)(spec)
        _close(got, getattr(j2, name)(spec), 1e-4, f"edge {name}")
        assert_close_to_golden(_np(got), g[f"edge_{name}"], tol, name)
    idx = np.array([0, 3, 17, 64, 127])
    for plan in (j2, t2):
        plan.set_edge_arr(idx)
        plan.set_edge(5, 2)          # refused: the subset stays
        plan.set_edge_arr([200])     # refused too
    for name in ("rolloff", "rms", "hfc", "decrease", "entropy"):
        _close(getattr(t2, name)(spec), getattr(j2, name)(spec), 1e-4,
               f"edge_arr {name}")


@pytest.mark.parametrize("name", ["pd", "wpd", "nwpd", "cd", "rcd"])
def test_spectral_phase_features(name, goldens):
    g = goldens("spectral")
    mspec, mphase = g["in_mspec"], g["in_mphase"]
    fre = np.linspace(0, 16000, mspec.shape[0]).astype(np.float32)
    j = af.Spectral(num=mspec.shape[0], fre_band_arr=fre)
    t = aft.Spectral(num=mspec.shape[0], fre_band_arr=fre, **CPU)
    got = getattr(t, name)(mspec, mphase)
    _close(got, getattr(j, name)(mspec, mphase), 1e-4, name)
    assert_close_to_golden(_np(got), g[name], 2e-4, name)


@pytest.mark.parametrize("i", range(10))
def test_fuzz_spectral_golden(goldens, i):
    """Every method off its defaults (tests/test_fuzz_goldens.py's sweep
    and tolerances); band_width, NaN where the C takes a root of a negative
    sum, by its NaN mask and finite part."""
    g = goldens("fuzz_spectral")
    p = json.loads(str(g[f"c{i}_params"]))
    spec, phase = g[f"c{i}_in_spec"], g[f"c{i}_in_phase"]
    t = aft.Spectral(num=p["num"], fre_band_arr=g[f"c{i}_in_fre"], **CPU)
    t.set_time_length(p["T"])
    t.set_edge(p["start"], p["end"])
    checks = {
        "flux": t.flux(spec, step=p["flux_step"], p=p["flux_p"],
                       is_positive=p["flux_pos"], is_exp=p["flux_exp"],
                       tp=p["flux_tp"]),
        "rolloff": t.rolloff(spec, threshold=p["rolloff_th"]),
        "entropy": t.entropy(spec, is_norm=p["ent_norm"]),
        "energy": t.energy(spec, is_log=p["en_log"], gamma=p["en_gamma"]),
        "sd": t.sd(spec, step=p["sd_step"], is_positive=p["sd_pos"]),
        "sf": t.sf(spec, step=p["sf_step"], is_positive=p["sf_pos"]),
        "mkl": t.mkl(spec, tp=p["mkl_tp"]),
        "broadband": t.broadband(spec, threshold=p["bb_th"]),
        "novelty": t.novelty(spec, step=p["nov_step"], threshold=p["nov_th"],
                             method_type=NM(p["nov_m"]),
                             data_type=ND(p["nov_d"])),
        "eef": t.eef(spec, is_norm=p["eef_norm"]),
        "eer": t.eer(spec, is_norm=p["eer_norm"], gamma=p["eer_gamma"]),
    }
    for name in ("flatness", "centroid", "spread", "skewness", "kurtosis",
                 "crest", "slope", "decrease", "rms", "hfc"):
        checks[name] = getattr(t, name)(spec)
    for name in ("max", "mean", "var"):
        checks[f"{name}_v"], checks[f"{name}_f"] = getattr(t, name)(spec)
    for name in ("pd", "wpd", "nwpd", "cd", "rcd"):
        checks[name] = getattr(t, name)(spec, phase)
    for name, ours in checks.items():
        assert_close_to_golden(_np(ours), g[f"c{i}_{name}"], 5e-5,
                               f"fuzz_spectral[{i}] {name}")
    ours = _np(t.band_width(spec, p=p["bw_p"]))
    ref = g[f"c{i}_band_width"]
    assert np.array_equal(np.isnan(ours), np.isnan(ref))
    m = ~np.isnan(ref)
    if p["bw_p"] == 1.0:  # zero by definition: the cancellation scale
        x = np.where(np.arange(p["num"])[:, None] >= p["start"], spec, 0)
        x = np.where(np.arange(p["num"])[:, None] <= p["end"], x, 0)
        f = g[f"c{i}_in_fre"]
        c = (f[:, None] * x).sum(0) / np.maximum(x.sum(0), 1e-20)
        cancel = (x * np.abs(f[:, None] - c)).sum(0)
        assert np.all(np.abs(ours - ref)[m] <= 1e-4 * cancel[m] + 1e-6)
    elif m.any():
        assert_close_to_golden(ours[m], ref[m], 5e-4, "band_width")


@pytest.mark.parametrize("num", [12, 84, 1025])
def test_deconv(num):
    """L = ceil_pow2(2 num): 32, 256 and 4096 (the FFT kernel tier's size
    on the card; its plain version here)."""
    rng = np.random.default_rng(num)
    spec = np.abs(rng.standard_normal((2, num, 7))).astype(np.float32)
    j, t = af.Deconv(num), aft.Deconv(num, **CPU)
    for a, b, what in zip(t.deconv(spec), j.deconv(spec),
                          ("timbre", "pitch")):
        _close(a, b, 1e-4, f"{what} num={num}")


# the forwarded features, their arguments, and how they are compared
_FORWARD = [
    ("flatness", ()), ("flux", (2, 1.0, True)), ("rolloff", (0.9,)),
    ("centroid", ()), ("spread", ()), ("skewness", ()), ("kurtosis", ()),
    ("entropy", (True,)), ("crest", ()), ("slope", ()), ("decrease", ()),
    ("band_width", ()), ("rms", ()), ("energy", (True, 5.0)), ("hfc", ()),
    ("sd", ()), ("sf", ()), ("mkl", ()), ("broadband", (1.0,)),
    ("novelty", (1, 0.0, NM.KL)), ("eef", ()), ("eer", ()),
]


def test_spectrogram_feature_surface(signals):
    kw = dict(num=64, samplate=SR, radix2_exp=11, slide_length=512)
    j, t = af.MelSpectrogram(**kw), aft.MelSpectrogram(**kw, **CPU)
    spec = np.asarray(j.spectrogram(signals["chord"]))
    own = aft.Spectral(64, t.fre_band_arr, **CPU)
    for name, args in _FORWARD:
        got = getattr(t, name)(spec, *args)
        assert torch.equal(got, getattr(own, name)(spec, *args)), name
        if name != "skewness":  # cancels: see test_spectral_feature
            _close(got, getattr(j, name)(spec, *args), 1e-4, name)
    for name in ("max", "mean", "var"):
        for a, b in zip(getattr(t, name)(spec), getattr(j, name)(spec)):
            _close(a, b, 1e-4, name)
    phase = np.angle(np.asarray(af.STFT(radix2_exp=11, slide_length=512)
                                .stft(signals["chord"])))[:64]
    for name in ("pd", "wpd", "nwpd", "cd", "rcd"):
        _close(getattr(t, name)(spec, phase), getattr(j, name)(spec, phase),
               1e-4, name)
    for plan in (j, t):
        plan.set_edge(3, 40)
    _close(t.centroid(spec), j.centroid(spec), 1e-4, "edge centroid")
    for plan in (j, t):
        plan.set_edge_arr([0, 5, 9, 63])
    _close(t.hfc(spec), j.hfc(spec), 1e-4, "edge_arr hfc")
    for a, b in zip(t.deconv(spec), j.deconv(spec)):
        _close(a, b, 1e-4, "deconv")


@pytest.mark.parametrize("cls,kw", [
    ("MelSpectrogram", dict(num=64)),
    ("MelSpectrogram", dict(num=64, data_type=SpectralDataType.MAG)),
    ("Spectrogram", dict(filter_bank_type=S.LINEAR)),
    ("Spectrogram", dict(filter_bank_type=S.LINEAR, low_fre=100.0,
                         high_fre=8000.0)),
    ("Spectrogram", dict(num=12, filter_bank_type=S.CHROMA)),
])
def test_spectrogram_preprocess(cls, kw, signals):
    j = getattr(af, cls)(samplate=SR, radix2_exp=11, slide_length=512, **kw)
    t = getattr(aft, cls)(samplate=SR, radix2_exp=11, slide_length=512,
                          **kw, **CPU)
    spec = np.asarray(j.spectrogram(signals["sine"]))
    _close(t.preprocess(spec), j.preprocess(spec), 1e-6, "preprocess")


@pytest.mark.parametrize("nt", list(NoveltyType), ids=lambda n: n.name)
def test_onset_every_novelty(nt, goldens):
    """Envelope against JAX and the golden (2e-4), points equal to both."""
    g = goldens("fuzz_onset")
    phase_based = nt.name in ("PD", "WPD", "NWPD", "CD", "RCD")
    spec = g["mag"] if phase_based else g["spec"]
    kw = dict(time_length=spec.shape[-1], fre_length=spec.shape[0],
              slide_length=512, samplate=SR, novelty_type=nt)
    j, t = af.Onset(**kw), aft.Onset(**kw, **CPU)
    args = (spec, g["phase"] if phase_based else None)
    pts, env, times = t.onset(*args)
    pts_j, env_j, times_j = j.onset(*args)
    assert isinstance(env, np.ndarray) and env.dtype == np.float32
    _close(env, env_j, 1e-4, f"{nt.name} env vs JAX")
    assert_close_to_golden(env, g[f"{nt.name}_env"], 2e-4, nt.name)
    np.testing.assert_array_equal(pts, np.asarray(pts_j))
    np.testing.assert_array_equal(pts, g[f"{nt.name}_points"])
    np.testing.assert_allclose(times, times_j)


def test_onset_filter_param_and_index(signals):
    """The frequency-axis max filter, a NoveltyParam off its defaults and a
    band subset, on a mel spectrogram of the chirp."""
    spec = np.asarray(af.MelSpectrogram(num=64, samplate=SR, radix2_exp=11,
                                        slide_length=256)
                      .spectrogram(signals["chirp"]))
    kw = dict(time_length=spec.shape[-1], fre_length=64, slide_length=256,
              samplate=SR, filter_order=5)
    j, t = af.Onset(**kw), aft.Onset(**kw, **CPU)
    for param, idx in ((None, None),
                       (jo.NoveltyParam(step=2, p=2.0, is_positive=0,
                                        is_exp=1, tp=1), None),
                       (None, np.arange(8, 40))):
        tp = None if param is None else to.NoveltyParam(**vars(param))
        pts, env, _ = t.onset(spec, novelty_param=tp, index_arr=idx)
        pts_j, env_j, _ = j.onset(spec, novelty_param=param, index_arr=idx)
        _close(env, env_j, 1e-4, "env")
        np.testing.assert_array_equal(pts, np.asarray(pts_j))
    with pytest.raises(ValueError):
        aft.Onset(novelty_type=NoveltyType.PD, **kw, **CPU).onset(spec)


@pytest.mark.parametrize("seed", range(4))
def test_peak_pick_equal(seed):
    rng = np.random.default_rng(seed)
    n = [1, 7, 60, 937][seed]
    env = rng.random(n).astype(np.float32)
    for args in ((3, 1, 10, 11, 3, 0.07), (0, 1, 0, 1, 0, 0.0),
                 (2, 2, 40, 3, 1, 0.01)):
        np.testing.assert_array_equal(to.peak_pick(env, *args),
                                      jo.peak_pick(env, *args))
    assert to.peak_pick(np.zeros(0, np.float32), 3, 1, 10, 11, 3,
                        0.07).size == 0
