"""The port's host-stage engines (PitchSTFT, Harmonic, PitchFFP) and its
copies of the candidate-queue code on the CPU (``device="cpu"``): frame
for frame against the JAX package on seeded inputs, against the reference
C goldens (the tolerances of tests/test_pitch_stft.py, test_harmonic.py
and test_pitch_ffp.py), and the queue functions equal to JAX's on a
seeded fuzz."""

import copy

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.mir import _queue_cut as j_cut
from audioflux_tpu.mir import _queue_util as j_q
from audioflux_tpu.mir._trist import trist as j_trist
from audioflux_tpu.utils import queue as j_uq
from audioflux_torch.mir import _queue_cut as t_cut
from audioflux_torch.mir import _queue_util as t_q
from audioflux_torch.mir._trist import trist as t_trist
from audioflux_torch.ops import cuda_fft

SR = 32000
CPU = {"device": "cpu"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def notes():
    """1.5 s of three damped harmonic notes (110, 196, 293.7 Hz) and a
    glide, with noise (seeded)."""
    rng = np.random.default_rng(23)
    seg = SR // 2
    t = np.arange(seg) / SR
    parts = []
    for f0 in (110.0, 196.0, 293.7):
        s = sum(a * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6))
                for k, a in enumerate([0.35, 0.25, 0.18, 0.1, 0.06], 1))
        parts.append(s * np.exp(-1.5 * t))
    x = np.concatenate(parts) + 0.003 * rng.standard_normal(3 * seg)
    return x.astype(np.float32)


# ------------------------------------------------------------- PitchSTFT

def test_pitch_stft_matches_golden_and_jax(goldens):
    g = goldens("pitch_stft")
    kw = dict(samplate=SR, radix2_exp=12, slide_length=1024)
    fre, db = aft.PitchSTFT(**kw, **CPU).pitch(g["x"])
    np.testing.assert_allclose(fre, g["fre"], atol=1e-3)
    np.testing.assert_allclose(db, g["db"], atol=1e-4)
    fj, dj = af.PitchSTFT(**kw).pitch(g["x"])
    np.testing.assert_allclose(fre, fj, atol=1e-3)
    np.testing.assert_allclose(db, dj, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(radix2_exp=12, slide_length=512),
                                dict(radix2_exp=11, slide_length=300,
                                     window_type=af.WindowType.HANN)])
def test_pitch_stft_frames_match_jax(notes, kw):
    """Frame for frame on the seeded notes."""
    t, j = aft.PitchSTFT(samplate=SR, **kw, **CPU), af.PitchSTFT(samplate=SR,
                                                                 **kw)
    fre, db = t.pitch(notes)
    fj, dj = j.pitch(notes)
    assert fre.shape == (t.cal_time_length(len(notes)),)
    np.testing.assert_allclose(fre, fj, atol=1e-3)
    np.testing.assert_allclose(db, dj, atol=1e-4)
    assert np.count_nonzero(fre) > len(fre) // 2


# -------------------------------------------------------------- Harmonic

def test_harmonic_matches_golden_and_jax(goldens):
    g = goldens("harmonic")
    counts = aft.Harmonic(samplate=SR, radix2_exp=12, **CPU).harmonic_count(
        g["x"], 100.0, 2000.0)
    np.testing.assert_array_equal(counts, g["counts"])
    np.testing.assert_array_equal(
        counts, af.Harmonic(samplate=SR, radix2_exp=12).harmonic_count(
            g["x"], 100.0, 2000.0))


@pytest.mark.parametrize("kw", [dict(), dict(radix2_exp=11, slide_length=400,
                                             window_type=af.WindowType.HANN)])
def test_harmonic_frames_match_jax(notes, kw):
    """The surviving peak lists frame for frame, and counts over bands."""
    t = aft.Harmonic(samplate=SR, **kw, **CPU).exec(notes)
    j = af.Harmonic(samplate=SR, **kw).exec(notes)
    assert len(t._peaks) == len(j._peaks)
    for pt, pj in zip(t._peaks, j._peaks):
        assert len(pt) == len(pj)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-5, atol=1e-5)
    for lo, hi in ((80, 4000), (100, 1000), (300, 600)):
        np.testing.assert_array_equal(t.count_range(lo, hi),
                                      j.count_range(lo, hi))
    with pytest.raises(ValueError):
        aft.Harmonic(**CPU).harmonic_count(notes, 10.0, 100.0)


# --------------------------------------------------------------- PitchFFP

def test_pitch_ffp_matches_golden_and_jax(goldens):
    g = goldens("pitch_ffp")
    kw = dict(samplate=SR, radix2_exp=12, slide_length=1024)
    fre, db = aft.PitchFFP(**kw, **CPU).pitch(g["x"])
    err = np.abs(fre - g["fre"])
    assert np.median(err) < 0.1
    assert err.max() < 1.0
    fj, dj = af.PitchFFP(**kw).pitch(g["x"])
    np.testing.assert_allclose(fre, fj, atol=1e-3)
    np.testing.assert_allclose(db, dj, atol=1e-4)


def _rows(rows):
    return [(list(r.fre), list(r.db), list(r.h), list(r.idx)) for r in rows]


@pytest.mark.parametrize("kw,n", [(dict(slide_length=1024), None),
                                  (dict(slide_length=1024, low_fre=60.0,
                                        high_fre=3000.0), SR)])
def test_pitch_ffp_frames_match_jax(notes, kw, n):
    """pitch, every candidate set (corr/cut rows), the success flags,
    lightness and temporal data, frame for frame (the JAX module corrects
    one peak per call: the second case takes the first second only)."""
    notes = notes[:n]
    flags = dict(has_corr_data=True, has_cut_data=True, has_flag_data=True,
                 has_light_data=True, has_temporal_data=True)
    t, j = aft.PitchFFP(samplate=SR, **kw, **CPU), af.PitchFFP(samplate=SR,
                                                               **kw)
    fre, db, ex = t.pitch(notes, **flags)
    fj, dj, exj = j.pitch(notes, **flags)
    np.testing.assert_allclose(fre, fj, atol=1e-3)
    np.testing.assert_allclose(db, dj, atol=1e-4)
    assert np.count_nonzero(fre) > len(fre) // 2
    for key in exj:
        for a, b in zip(ex[key], exj[key]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                       err_msg=key)
    for a, b in zip(_rows(t._chain.fast3), _rows(j._chain.fast3)):
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                                   atol=1e-3)
        assert a[3] == b[3]


def test_ffp_peak_correction_matches_scalar_path(notes):
    """The host correction of every bin at once equals the JAX module's
    one-peak-at-a-time call of its correction on float64 magnitudes."""
    from audioflux_tpu.ops.correct import correct_fn
    chain = aft.PitchFFP(samplate=SR, **CPU)._chain
    rng = np.random.default_rng(3)
    P = rng.random((3, 40)) ** 4
    P[0, 5] = P[0, 7]        # neighbours equal: the pick's tie
    P[1, 10] = np.nextafter(P[1, 12], 0)   # equal once rounded to float32
    scale = chain._peak_scale(P)
    jc = correct_fn(af.WindowType.HAMM)
    for i in range(3):
        for jj in range(1, 39):
            ref, _ = jc(float(np.sqrt(P[i, jj])), float(np.sqrt(P[i, jj - 1])),
                        float(np.sqrt(P[i, jj + 1])))
            assert scale[i, jj] == float(ref), (i, jj)


def test_host_engines_run_their_fft_through_the_wrappers(notes, monkeypatch):
    """PitchSTFT, Harmonic and PitchFFP take their spectrum from
    ``ops.fft.rfft`` at 4096 (the FFT kernel's wrapper on the card)."""
    seen = []
    real = cuda_fft.fft_fwd

    def spy(xr, xi=None, *args, **kwargs):
        seen.append(xr.shape[-1])
        return real(xr, xi, *args, **kwargs)
    monkeypatch.setattr(cuda_fft, "fft_fwd", spy)
    aft.PitchSTFT(**CPU).pitch(notes)
    aft.Harmonic(**CPU).exec(notes)
    aft.PitchFFP(**CPU).pitch(notes)
    assert seen == [4096, 4096, 4096]


# ------------------------------------------------------------ the queues

def _candidates(rng):
    """A frame's three candidate sets as the FFP chain makes them: a
    harmonic stack on a string's register (or noise), each set a subset of
    the next, ascending in frequency, with dB ranks."""
    strings = [82.4, 98.0, 110.0, 146.8, 196.0, 246.9, 329.6, 100.0]
    base = float(np.float32(strings[int(rng.integers(0, 8))]
                            + rng.normal(0, 2)))
    rn = int(rng.integers(1, 13))
    if rng.random() < 0.8:
        lo = 1 if rng.random() < 0.4 else 2
        ks = np.sort(rng.choice(np.arange(lo, lo + 13), rn, replace=False))
        fre3 = np.abs(base * ks + rng.normal(0, 1.2, rn)) + 1
    else:
        fre3 = rng.uniform(40, 3000, rn)
    fre3 = np.sort(np.float32(fre3))
    rn = len(fre3)
    db3 = np.float32(-10 - 2.0 * np.arange(rn) + rng.normal(0, 6, rn))
    if rng.random() < 0.5:
        db3[int(rng.integers(0, min(4, rn)))] += rng.uniform(10, 25)
    h3 = np.float32(np.abs(rng.normal(15, 8, rn)))
    n2 = int(rng.integers(1, rn + 1))
    n = int(rng.integers(1, n2 + 1))
    sel2 = np.sort(rng.choice(rn, n2, replace=False))
    sel = np.sort(rng.choice(n2, n, replace=False))
    f2, d2, h2 = fre3[sel2], db3[sel2], h3[sel2]
    f1, d1, h1 = f2[sel], d2[sel], h2[sel]
    idx = np.empty(n, np.int64)
    idx[np.argsort(-d1, kind="stable")] = np.arange(n)

    def L(a):
        return [float(v) for v in a]
    light = float(rng.choice([0.0, 0.2, 0.985, 1.0]))
    return ((L(f1), L(d1), L(h1), [int(v) for v in idx], n),
            (L(f2), L(d2), L(h2), n2), (L(fre3), L(db3), L(h3), rn), light)


def _both(fj, ft, *args, **kw):
    """Call JAX's and the port's copy on deep copies of the same arguments
    (several sort their lists in place); the results and the arguments
    afterwards must be equal."""
    aj, at = copy.deepcopy(args), copy.deepcopy(args)
    rj, rt = fj(*aj, **kw), ft(*at, **kw)
    assert rj == rt, (fj.__name__, args)
    assert aj == at, (fj.__name__, "in-place edits differ")
    return rt


@pytest.mark.parametrize("seed", range(4))
def test_queue_copies_equal_jax_on_a_seeded_fuzz(seed):
    """300 frames a seed: the ratio primitives, the six strategies, the
    cut engine and both resolution cascades return what JAX's return."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(300):
        (f1, d1, h1, idx, n), (f2, d2, h2, n2), (f3, d3, h3, rn), light = \
            _candidates(rng)
        if n >= 2:
            _both(j_q.cal_range_times, t_q.cal_range_times, f1[0], f1[1])
            _both(j_q.queue_fre2, t_q.queue_fre2, f1[0], f1[1])
            _both(j_uq.queue_fre2, aft.utils.queue_fre2, f1[0], f1[1])
        if n >= 3:
            _both(j_q.queue_fre3, t_q.queue_fre3, f1[0], f1[1], f1[2])
            _both(j_uq.queue_fre3, aft.utils.queue_fre3, f1[0], f1[1], f1[2])
        one = (f1, d1, h1, idx, n)
        for name in ("queue_direct", "queue_weak", "queue_slide"):
            _both(getattr(j_q, name), getattr(t_q, name), *one, light, 0)
        _both(j_q.queue_fast, t_q.queue_fast, *one, f2, d2, h2, n2, light, 0)
        full = one + (f2, d2, h2, n2, f3, d3, h3, rn, light, 0)
        _both(j_q.queue_standard, t_q.queue_standard, *full)
        _both(j_cut.queue_cut, t_cut.queue_cut, *full)
        _both(j_q.trist_dispatch, t_q.trist_dispatch, f1, d1, h1, n, light)
        _both(j_q.trist3_resolve, t_q.trist3_resolve, f3, d3, h3, rn,
              f2, d2, h2, n2, f1, d1, h1, n, light)


def test_trist_copy_equals_jax():
    rng = np.random.default_rng(9)
    for _ in range(200):
        n = 8
        f0 = rng.uniform(60, 500)
        ks = np.sort(rng.choice(np.arange(1, 12), n, replace=False))
        corr = f0 * ks + rng.normal(0, 1, n)
        db = np.sort(rng.uniform(-70, -5, n))[::-1].copy()
        h = rng.uniform(0, 40, n)
        midi = np.round(12 * np.log2(corr / 440) + 69).astype(np.int64)
        c1, c2 = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        args = (corr, db, h, midi, corr.copy(), db.copy(), h.copy(),
                midi.copy(), c1, c2)
        assert j_trist(*copy.deepcopy(args)) == t_trist(*copy.deepcopy(args))


def test_device_policy():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (aft.PitchSTFT, aft.Harmonic, aft.PitchFFP):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
