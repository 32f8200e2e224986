"""The port's Deep and DeepChroma spectrograms, Cepstrogram, the peak
corrections of ``ops.correct`` and the legacy presets of
``audioflux_torch.spectrogram`` on the CPU (``device="cpu"``): against the
JAX package on the CPU on the same seeded inputs (2e-6 of the peak unless
a case says otherwise), against the reference C goldens at
tests/test_deep.py's, tests/test_features.py's and
tests/test_fuzz_goldens.py's tolerances, and the slot bookkeeping of
Deep's peak projection against the TPU package's one-hot model written
out in numpy."""

import json

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu import spectrogram as jlegacy
from audioflux_tpu.ops import correct as jcorrect
from audioflux_torch import spectrogram as tlegacy
from audioflux_torch.ops import correct as tcorrect
from audioflux_torch.transforms import deep as tdeep
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


def _music(n, k=2, seed=3):
    """Tones a few semitones apart with vibrato, plus noise, loud enough
    to pass the salience thresholds (peak >= 13)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 32000
    out = []
    for i in range(k):
        f = 220.0 * 2 ** (i / 12) * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))
        ph = 2 * np.pi * np.cumsum(f) / 32000
        out.append(sum(np.sin(h * ph) / h for h in (1, 2, 3, 5))
                   + 0.05 * rng.standard_normal(n))
    return np.asarray(out, np.float32) * 20


def _one_hot_model(vals, tgt, n_slots):
    """The TPU package's model (transforms/deep.py): one-hot scores, the
    exclusive running max per slot, and 'improving' cells."""
    scores = np.zeros(vals.shape + (n_slots + 1,), np.float32)
    np.put_along_axis(scores, tgt[..., None], vals[..., None], axis=-1)
    scores = scores[..., :n_slots]
    cmax = np.maximum.accumulate(scores, axis=-2)
    prev = np.concatenate([np.zeros_like(cmax[..., :1, :]),
                           cmax[..., :-1, :]], axis=-2)
    return (scores > prev).any(axis=-1)


@pytest.mark.parametrize("seed", range(4))
def test_improving_against_the_one_hot_model(seed):
    """Many peaks to a slot, repeated values (a tie does not improve),
    zeros and the trash slot."""
    rng = np.random.default_rng(seed)
    n_slots = 5
    vals = rng.integers(0, 6, (3, 7, 64)).astype(np.float32)
    tgt = rng.integers(0, n_slots + 1, vals.shape)
    vals[tgt == n_slots] = 0.0
    got = tdeep._improving(torch.from_numpy(vals), torch.from_numpy(tgt),
                           n_slots)
    assert np.array_equal(got.numpy(), _one_hot_model(vals, tgt, n_slots))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_deep_vs_jax(order):
    x = _music(32000)
    t = aft.DeepSpectrogram(num=60, radix2_exp=11, **CPU)
    j = af.DeepSpectrogram(num=60, radix2_exp=11)
    if order != 1:
        t.set_deep_order(order)
        j.set_deep_order(order)
    got = t.spectrogram(x)
    assert tuple(got.shape[-3:-1]) == (3 if order < 3 else 5, 60)
    _close(got, j.spectrogram(x), label=f"deep order {order}")
    assert float(got[:, 1:].abs().sum()) > 0    # neighbour channels written


@pytest.mark.parametrize("kw", [
    dict(),
    dict(radix2_exp=11, window_type=aft.WindowType.HANN, slide_length=300,
         data_type=aft.SpectralDataType.MAG, low_fre=100.0, high_fre=8000.0),
    dict(radix2_exp=11, window_type=aft.WindowType.RECT, num=13),  # -> 12
], ids=["default", "hann-mag", "rect"])
def test_deep_chroma_vs_jax(kw):
    x = _music(24000)
    _close(aft.DeepChromaSpectrogram(**kw, **CPU).spectrogram(x),
           af.DeepChromaSpectrogram(**kw).spectrogram(x), label=f"{kw}")


def test_deep_goldens(goldens):
    g = goldens("deep")
    x = g["in_x"]
    D = _np(aft.DeepSpectrogram(num=84, samplate=32000, radix2_exp=12,
                                **CPU).spectrogram(x))
    assert D.shape == g["deep"].shape
    for ch in range(3):
        assert_close_to_golden(D[ch], g["deep"][ch], 5e-5, f"deep_ch{ch}")
    for k in (2, 3, 4):
        dp = aft.DeepSpectrogram(num=84, samplate=32000, radix2_exp=12, **CPU)
        dp.set_deep_order(k)
        D = _np(dp.spectrogram(x))
        ref = g[f"deep_o{k}"]
        assert D.shape == ref.shape
        for ch in range(ref.shape[0]):
            assert_close_to_golden(D[ch], ref[ch], 5e-5, f"deep_o{k}_ch{ch}")
    C = aft.DeepChromaSpectrogram(samplate=32000, radix2_exp=12,
                                  **CPU).spectrogram(x)
    assert_close_to_golden(_np(C), g["deep_chroma"], 5e-5, "deep_chroma")


@pytest.mark.parametrize("i", range(7))       # test_fuzz_goldens N_DEEP_FUZZ
def test_fuzz_deep_goldens(goldens, signals, i):
    g = goldens("fuzz_deep")
    p = json.loads(str(g[f"c{i}_params"]))
    tag = f"fuzz_deep[{i}] {p}"
    ref = g[f"c{i}_arr"]
    x = signals["chord"]
    if p["kind"] == "deep":
        dp = aft.DeepSpectrogram(num=p["num"], samplate=p["sr"],
                                 radix2_exp=p["r2e"], **CPU)
        if p["order"] != 1:
            dp.set_deep_order(p["order"])
        D = _np(dp.spectrogram(x))
        assert D.shape == ref.shape, tag
        for ch in range(ref.shape[0]):
            assert_close_to_golden(D[ch], ref[ch], 5e-5, f"{tag} ch{ch}")
    else:
        dc = aft.DeepChromaSpectrogram(samplate=p["sr"], radix2_exp=p["r2e"],
                                       **CPU)
        assert_close_to_golden(_np(dc.spectrogram(x)), ref, 5e-5, tag)


def test_deep_argument_checks():
    with pytest.raises(ValueError):
        aft.DeepSpectrogram(**CPU).set_deep_order(5)
    assert aft.DeepSpectrogram(window_type=aft.WindowType.KAISER,
                               **CPU).window_type == aft.WindowType.HAMM


@pytest.mark.parametrize("wt", [aft.WindowType.RECT, aft.WindowType.HANN,
                                aft.WindowType.HAMM])
def test_correct_fn_vs_jax(wt):
    rng = np.random.default_rng(4)
    cur = np.abs(rng.standard_normal((4, 300))).astype(np.float32) + 0.5
    left, right = (np.abs(rng.standard_normal((4, 300))).astype(np.float32)
                   * cur for _ in range(2))
    left[0, :10] = right[0, :10]                  # equal neighbours
    right[1, :10] = 0.0                           # a zero neighbour
    det, val = tcorrect.correct_fn(wt)(*(torch.from_numpy(a)
                                         for a in (cur, left, right)))
    jdet, jval = jcorrect.correct_fn(wt)(cur, left, right)
    np.testing.assert_allclose(_np(det), np.asarray(jdet), rtol=0,
                               atol=2e-6)
    _close(val, jval, label=f"amplitude {wt.name}")


def test_cepstrogram_vs_jax():
    x = _music(20000)
    for kw, cep in ((dict(radix2_exp=11, slide_length=512), 32),
                    (dict(radix2_exp=10, window_type=aft.WindowType.HANN,
                          slide_length=0), 4)):
        t = aft.Cepstrogram(**kw, **CPU).cepstrogram(x, cep_num=cep)
        j = af.Cepstrogram(**kw).cepstrogram(x, cep_num=cep)
        # log() amplifies the float32 rounding of bins far below the peak,
        # and the details re-transform the whole cepstrum, summing that
        # error over the frame (the golden tests allow 5e-5 and 2e-3)
        for a, b, what, tol in zip(t, j, ("ceps", "env", "det"),
                                   (1e-5, 1e-5, 2e-4)):
            _close(a, b, tol, label=f"cepstrogram {kw} {what}")
    with pytest.raises(ValueError):
        aft.Cepstrogram(**CPU).cepstrogram(x, cep_num=2)


def test_cepstrogram_golden(goldens, signals):
    g = goldens("features")
    cp = aft.Cepstrogram(radix2_exp=11, samplate=32000, slide_length=512,
                         **CPU)
    c1, c2, c3 = (_np(c) for c in cp.cepstrogram(signals["chord"],
                                                  cep_num=32))
    assert_close_to_golden(c1, g["ceps"], 5e-5, "ceps")
    assert_close_to_golden(c2, g["ceps_env"], 5e-5, "ceps_env")
    assert_close_to_golden(c3, g["ceps_det"], 2e-3, "ceps_det")


@pytest.mark.parametrize("name,args", [
    ("Linear", ()), ("Mel", ()), ("Bark", (64,)), ("Erb", ()),
    ("Chroma", ()), ("Deep", (48,)), ("DeepChroma", ())])
def test_legacy_presets_vs_jax(name, args):
    x = _music(16384)
    t = getattr(tlegacy, name)(*args, radix2_exp=11, **CPU)
    j = getattr(jlegacy, name)(*args, radix2_exp=11)
    assert t.device == torch.device("cpu")
    _close(t.spectrogram(x), j.spectrogram(x), 1e-5, label=name)


def test_deep_load_reference_constants():
    """A JAX plan's window and chroma fold (altered) installed into the
    port plans."""
    x = _music(20000)
    j = af.DeepChromaSpectrogram(radix2_exp=11)
    j.window = (j.window * np.linspace(0.8, 1.0, 2048)).astype(np.float32)
    j._fold = (j._fold[::-1] * 1.1).astype(np.float32)
    j._spec_run = __import__("jax").jit(j._spec_impl)
    t = aft.DeepChromaSpectrogram(radix2_exp=11, **CPU)
    aft.load_reference_constants(t, window=j.window,
                                 chroma_filter_bank=j._fold)
    _close(t.spectrogram(x), j.spectrogram(x), label="installed constants")
    d = aft.DeepSpectrogram(num=40, radix2_exp=11, **CPU)
    aft.load_reference_constants(d, window=j.window)
    assert np.array_equal(_np(d._window_t), j.window)
    with pytest.raises(ValueError, match="window"):
        aft.load_reference_constants(d, window=j.window[1:])
