"""The port's band-sharded and spliced full-signal transforms and its
batch wrappers on the CPU mesh, against the JAX package's unsharded
transforms at the tolerances of the matching cases of
tests/test_sharded_full.py, and against the port's own unsharded calls.

Where a plan's constants are sliced per shard (CWT's bank, ST's windows,
NSGT's windows) they are held array-equal to the JAX plan's.  Synsq and
WSST scatter by rounding a float32 bin index, and the JAX package's jitted
CPU code contracts a multiply-add that the port's does not, so they are
held to the JAX package by the benchmark's flips-and-mass gate and to the
port's unsharded call at tests/test_sharded_full.py's 1e-5 of the peak.
"""

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.types import (SpectralFilterBankScaleType as S,
                                 WaveletContinueType as W)
from audioflux_torch.parallel import make_mesh
from audioflux_torch.parallel.sharded_full import (
    sharded_batch_fn, sharded_batch_map_fn, sharded_ccwt_fn, sharded_cqt_fn,
    sharded_cst_fn, sharded_cwt_fn, sharded_fst_fn, sharded_nsgt_fn,
    sharded_pwt_fn, sharded_st_fn, sharded_synsq_fn, sharded_wsst_fn)

SR = 32000
GRIDS = [(1, 1), (1, 2), (2, 2), (2, 4), (1, 8)]
CPU = {"device": "cpu"}


def _mesh(data=2, time=4):
    return make_mesh(data=data, time=time,
                     devices=[torch.device("cpu")] * (data * time))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _flips_mass(got, want):
    got, want = np.abs(_np(got)), np.abs(np.asarray(want))
    flips = (np.abs(got - want) > 1e-5 * want.max()).mean()
    mass = abs(got.sum() / want.sum() - 1)
    assert flips <= 5e-3, flips
    assert mass <= 1e-4, mass


def _sig(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1234.5 * t)
         + 0.05 * rng.standard_normal(n))
    return np.stack([x, x[::-1]]).astype(np.float32)  # (2, n)


CWT_KW = dict(num=28, radix2_exp=11, samplate=SR,
              wavelet_type=W.MORSE, scale_type=S.OCTAVE)


@pytest.fixture(scope="module")
def cwt_pair():
    j, t = af.CWT(**CWT_KW), aft.CWT(**CWT_KW, **CPU)
    assert np.array_equal(t._bank, j._bank)
    return j, t


@pytest.mark.parametrize("data,time", GRIDS)
def test_sharded_cwt(cwt_pair, data, time):
    j, t = cwt_pair
    x = _sig(2048, seed=1)
    got = sharded_cwt_fn(t, _mesh(data, time))(x)
    _close(got, j.cwt(x), 2e-5)
    assert torch.equal(got, t.cwt(x))


def test_sharded_cwt_det_and_pwt(cwt_pair):
    j, t = cwt_pair
    x = _sig(2048, seed=2)
    got = sharded_cwt_fn(t, _mesh(), det=True)(x)
    _close(got, j.cwt_det(x), 2e-5)
    assert np.array_equal(t._det_bank, j._det_bank)
    jp, tp = af.PWT(num=28, radix2_exp=11), aft.PWT(num=28, radix2_exp=11,
                                                    **CPU)
    assert np.array_equal(tp._bank, jp._bank)
    x = _sig(2048, seed=12)
    _close(sharded_pwt_fn(tp, _mesh())(x), jp.pwt(x), 2e-5)


@pytest.mark.parametrize("order", [1, 2])
def test_sharded_synsq(cwt_pair, order):
    j, t = cwt_pair
    x = _sig(2048, seed=3)
    jsq = af.Synsq(num=28, radix2_exp=11, samplate=SR, order=order)
    tsq = aft.Synsq(num=28, radix2_exp=11, samplate=SR, order=order, **CPU)
    got = sharded_synsq_fn(t, tsq, _mesh())(x)
    _close(got, tsq.synsq(t.cwt(x), t.scale_type, t.fre_band_arr), 1e-5)
    _flips_mass(got, jsq.synsq(j.cwt(x), j.scale_type, j.fre_band_arr))


@pytest.mark.parametrize("order", [1, 2])
def test_sharded_wsst(order):
    kw = dict(num=28, radix2_exp=11, samplate=SR, wavelet_type=W.MORSE,
              scale_type=S.OCTAVE)
    jw, tw = af.WSST(**kw), aft.WSST(**kw, **CPU)
    jw.set_order(order)
    tw.set_order(order)
    x = _sig(2048, seed=9)
    sq, D = sharded_wsst_fn(tw, _mesh())(x)
    sq0, D0 = tw.wsst(x)
    assert torch.equal(D, D0)
    _close(sq, sq0, 1e-5)
    sqj, Dj = jw.wsst(x)
    _close(D, Dj, 2e-5)
    _flips_mass(sq, sqj)


@pytest.mark.parametrize("data,time", GRIDS)
def test_sharded_st(data, time):
    kw = dict(radix2_exp=10, samplate=SR, min_index=1, max_index=100)
    j, t = af.ST(**kw), aft.ST(**kw, **CPU)
    assert np.array_equal(t._windows, np.asarray(j._windows))
    x = _sig(1024, seed=4)
    got = sharded_st_fn(t, _mesh(data, time))(x)
    _close(got, j.st(x), 2e-6)
    assert torch.equal(got, t.st(x))


def test_sharded_st_with_bin_zero():
    """Bin 0 (the mean row) on the first shard only."""
    t = aft.ST(radix2_exp=9, min_index=0, max_index=40, **CPU)
    x = _sig(512, seed=14)
    assert torch.equal(sharded_st_fn(t, _mesh())(x), t.st(x))


@pytest.mark.parametrize("data,time", GRIDS)
def test_sharded_nsgt(data, time):
    kw = dict(num=24, radix2_exp=11, samplate=SR, scale_type=S.OCTAVE)
    j, t = af.NSGT(**kw), aft.NSGT(**kw, **CPU)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(t._windows, j._windows))
    x = _sig(2048, seed=5)
    got = sharded_nsgt_fn(t, _mesh(data, time))(x)
    _close(got, j.nsgt(x), 5e-6)
    _close(got, t.nsgt(x), 1e-7)


@pytest.mark.parametrize("data,time", [(1, 2), (2, 4), (1, 8)])
def test_sharded_fst(data, time):
    kw = dict(radix2_exp=9, samplate=SR, min_index=1, max_index=200)
    j, t = af.FST(**kw), aft.FST(**kw, **CPU)
    x = _sig(512, seed=11)
    got = sharded_fst_fn(t, _mesh(data, time))(x)
    assert torch.equal(got, t.fst(x))      # disjoint gathers: bit-equal
    _close(got, j.fst(x), 1e-6)


@pytest.mark.parametrize("data,time,batch", [(1, 2, 2), (2, 4, 8),
                                             (1, 8, 10), (2, 4, 3)])
def test_sharded_cqt(data, time, batch):
    kw = dict(num=24, samplate=SR, bin_per_octave=12, low_fre=220.0)
    j, t = af.CQT(**kw), aft.CQT(**kw, **CPU)
    x = np.concatenate([_sig(8192, seed=6 + s)
                        for s in range(-(-batch // 2))])[:batch]
    got = sharded_cqt_fn(t, _mesh(data, time))(x)
    _close(got, j.cqt(x), 2e-6)
    assert torch.equal(got, t.cqt(x))


@pytest.mark.parametrize("data,time", [(1, 2), (2, 2), (2, 4), (1, 8)])
def test_sharded_ccwt(cwt_pair, data, time):
    j, t = cwt_pair
    step = t.fft_length // 2
    x = _sig(time * 2 * step, seed=7)
    got = sharded_ccwt_fn(t, _mesh(data, time))(x)
    _close(got, j.ccwt(x), 1e-6)
    _close(got, t.ccwt(x), 1e-7)


@pytest.mark.parametrize("data,time", [(1, 2), (2, 4), (1, 8)])
def test_sharded_cst(data, time):
    kw = dict(radix2_exp=10, samplate=SR, min_index=1, max_index=64)
    j, t = af.ST(**kw), aft.ST(**kw, **CPU)
    x = _sig(time * 2 * (t.fft_length // 2), seed=9)
    got = sharded_cst_fn(t, _mesh(data, time))(x)
    _close(got, j.cst(x), 2e-6)
    _close(got, t.cst(x), 1e-7)


def test_sharded_ccwt_unaligned_block_raises(cwt_pair):
    _, t = cwt_pair
    step = t.fft_length // 2
    x = _sig(4 * (step + 128), seed=8)
    with pytest.raises(ValueError, match="multiple of fft_length//2"):
        sharded_ccwt_fn(t, _mesh(1, 4))(x)
    with pytest.raises(ValueError, match="too short"):
        sharded_ccwt_fn(t, _mesh(1, 1))(_sig(step, seed=8))


@pytest.mark.parametrize("mode", ["auto", "gspmd", "shard_map"])
def test_modes_run_the_same_form(cwt_pair, mode):
    _, t = cwt_pair
    x = _sig(2048, seed=13)
    want = t.cwt(x)
    for fn in (sharded_cwt_fn(t, _mesh(), mode=mode),
               sharded_cwt_fn(t, _mesh(), mode=mode, interpret=True)):
        assert torch.equal(fn(x), want)


def test_bad_mode_raises(cwt_pair):
    _, t = cwt_pair
    with pytest.raises(ValueError, match="mode must be"):
        sharded_cwt_fn(t, _mesh(), mode="pjit")
    st = aft.ST(radix2_exp=9, **CPU)
    with pytest.raises(ValueError, match="mode must be"):
        sharded_st_fn(st, _mesh(), mode="spmd")


def test_band_shards_with_no_bands():
    """More band shards than bands: the empty shards are skipped."""
    t = aft.CWT(num=3, radix2_exp=9, samplate=SR, **CPU)
    x = _sig(512, seed=15)
    assert torch.equal(sharded_cwt_fn(t, _mesh(1, 8))(x), t.cwt(x))


def test_sharded_batch_map_hpss_yin():
    """The config-5 MIR calls through the batch map: bit-equal to the
    unsharded calls (the batch split reorders nothing)."""
    x = np.random.default_rng(4).standard_normal((8, 16384)).astype(
        np.float32)
    hp = aft.HPSS(radix2_exp=11, window_type=aft.WindowType.HAMM,
                  slide_length=512, h_order=21, p_order=31, **CPU)
    yin = aft.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024, **CPU)
    for fn in (hp.hpss, yin.pitch):
        got = sharded_batch_map_fn(fn, _mesh())(x)
        want = fn(x)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))
    with pytest.raises(ValueError, match="must divide"):
        sharded_batch_map_fn(hp.hpss, _mesh())(x[:3])


def test_sharded_batch_fn_uneven_and_nested():
    mel = aft.MelSpectrogram(num=32, samplate=SR, radix2_exp=9,
                             slide_length=128, **CPU)

    def pipeline(v):
        spec = mel.spectrogram(v)
        flux = ((spec[..., 1:] - spec[..., :-1]).clamp(min=0) ** 2).sum(-2)
        return {"spec": spec, "flux": flux}

    x = np.concatenate([_sig(4096, seed=s) for s in range(3)])  # (6, n)
    got = sharded_batch_fn(pipeline, _mesh(4, 2))(x)
    want = pipeline(x)
    np.testing.assert_allclose(_np(got["spec"]), _np(want["spec"]),
                               rtol=1e-6, atol=1e-6 * float(want["spec"].max()))
    np.testing.assert_allclose(_np(got["flux"]), _np(want["flux"]),
                               rtol=1e-6, atol=1e-6 * float(want["flux"].max()))
