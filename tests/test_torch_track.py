"""The port's ``TuneTrack`` on the CPU (``device="cpu"``), frame for frame
against the JAX package: the slice as a whole (YIN, PitchFFP,
HarmonicRatio, Harmonic and two spectrograms under the tuner's state
machine), on the two-note clip of tests/test_tune_track.py and on a
seeded clip."""

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft

SR = 32000
CPU = {"device": "cpu"}


def _pluck(f0, seg, sr, rng, partials=(0.35, 0.28, 0.18, 0.1, 0.06, 0.04),
           decay=2.0):
    t = np.arange(seg) / sr
    s = np.zeros(seg)
    for k, a in enumerate(partials, start=1):
        s += a * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6))
    return s * np.exp(-t * decay)


def _two_notes():
    """tests/test_tune_track.py's clip: 220 Hz then 329.6 Hz, 1 s each."""
    rng = np.random.default_rng(7)
    x = np.concatenate([_pluck(220.0, SR, SR, rng),
                        _pluck(329.6, SR, SR, rng)]).astype(np.float32)
    x += 0.002 * rng.standard_normal(len(x)).astype(np.float32)
    return x


def _strings():
    """A seeded clip: four open strings, 0.3 s each, over a noise floor."""
    rng = np.random.default_rng(31)
    seg = 3 * SR // 10
    x = np.concatenate([_pluck(f0, seg, SR, rng, decay=1.5)
                        for f0 in (82.41, 146.83, 246.94, 196.0)])
    return (x + 0.0025 * rng.standard_normal(len(x))).astype(np.float32)


@pytest.mark.parametrize("make", [_two_notes, _strings],
                         ids=["two_notes", "seeded_strings"])
def test_tune_track_matches_jax_frame_for_frame(make):
    x = make()
    kw = dict(samplate=SR, radix2_exp=12, slide_length=1024)
    t, j = aft.TuneTrack(**kw, **CPU), af.TuneTrack(**kw)
    fre, ref = t.tune(x), j.tune(x)
    assert fre.shape == ref.shape == (t.cal_time_length(len(x)),)
    np.testing.assert_array_equal(fre > 0, ref > 0)
    np.testing.assert_allclose(fre, ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(t.get_data_arr(), j.get_data_arr(),
                               rtol=1e-4, atol=1e-3)
    assert np.count_nonzero(fre) > 0


def test_tune_track_two_notes_tracks_the_notes():
    """tests/test_tune_track.py's gate, on the port."""
    fre = aft.TuneTrack(samplate=SR, **CPU).tune(_two_notes())
    T = len(fre)
    first, second = fre[4:T // 2 - 4], fre[T // 2 + 4:T - 4]
    first, second = first[first > 0], second[second > 0]
    assert len(first) and abs(np.median(first) - 220) < 3
    assert len(second) and abs(np.median(second) - 329.6) < 4


def test_tune_track_clear_and_tensor_input():
    """``clear`` resets the state (a second call equals the first), and a
    tensor input is taken to the host like an array."""
    x = (0.5 * np.sin(2 * np.pi * 440 * np.arange(SR) / SR)).astype(np.float32)
    tt = aft.TuneTrack(samplate=SR, **CPU)
    f1 = tt.tune(x)
    tt.clear()
    np.testing.assert_array_equal(f1, tt.tune(torch.from_numpy(x)))


def test_device_policy():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aft.TuneTrack()
