"""Sharded results that stay on their devices (``keep_sharded=True``),
sharded inputs that chain without a gather, Synsq's reduce-scatter and the
frame-sharded CQT, on the CPU mesh of eight repeated devices.

Every kept result is held shard by shard against the JAX package's
``addressable_shards`` on its 8-device CPU mesh at the same mesh position:
the index equal where JAX hands back its ``out_specs``, and the value at
the tolerance of the existing test of that function (1e-4 of the peak for
the halo-sharded family, tests/test_torch_parallel.py; 2e-5 CWT/PWT, 2e-6
ST and CQT, 5e-6 NSGT, 1e-6 FST and ccwt, 2e-6 cst,
tests/test_torch_sharded_full.py).  Where JAX's trailing trim hands back a
result replicated over ``time`` (the STFT, the spectrogram, the GSPMD
CQT), the port follows the ``out_specs`` and each of its parts is held
against the region of JAX's shard at the same position.  Synsq/WSST are
held by the flips-and-mass gate, as tests/test_torch_sharded_full.py
holds them.  ``gather()`` is ``torch.equal`` to the default call.

JAX's GSPMD CQT needs B to divide the ``data`` axis; for B = 1 and B = 3
its oracle runs on the batch padded with copies of the last clip, and
its rows are compared."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.ops.window import get_fft_window as j_window
from audioflux_tpu.parallel import make_mesh as j_make_mesh
from audioflux_tpu.parallel import sharded as j_sharded
from audioflux_tpu.parallel import sharded_full as j_full
from audioflux_tpu.parallel.distributed import global_from_local as j_gfl
from audioflux_tpu.parallel.features import sharded_spectral_stats_fn as j_stats
from audioflux_tpu.types import (SpectralFilterBankScaleType as S,
                                 WaveletContinueType as W)
from audioflux_torch.parallel import (ShardedTensor, _shard, features,
                                      make_mesh, sharded, sharded_full)
from audioflux_torch.parallel.distributed import global_from_local

SR, FFT, SLIDE = 32000, 2048, 512
CPU = {"device": "cpu"}
CWT_KW = dict(num=28, radix2_exp=11, samplate=SR, wavelet_type=W.MORSE,
              scale_type=S.OCTAVE)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=2, time=4, devices=[torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(data=2, time=4)


def _bounds(index, shape):
    return [sl.indices(n)[:2] for sl, n in zip(index, shape)]


def _sig(shape, seed, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _put(x, jmesh, *spec):
    return jax.device_put(x, NamedSharding(jmesh, P(*spec)))


def _match(kept, jarr, jmesh, tol=None, same_index=True, cmp=None):
    """Each kept shard against JAX's shard at its mesh position: on its
    mesh device, its index JAX's (``same_index=True``), inside JAX's
    (``"inside"``) or anywhere (``False``: JAX's slice of its padded bands
    re-shards the result, and the part is held against the global array),
    its value within ``tol`` of JAX's peak (or ``cmp(got, want)``)."""
    assert isinstance(kept, ShardedTensor)
    assert kept.shape == tuple(jarr.shape)
    where = {d: pos for pos, d in np.ndenumerate(jmesh.devices)}
    jsh = {where[s.device]: s for s in jarr.addressable_shards}
    peak = float(np.abs(np.asarray(jarr)).max())
    if same_index is True:
        want = {tuple(map(tuple, _bounds(s.index, jarr.shape)))
                for s in jarr.addressable_shards}
        assert {tuple(map(tuple, _bounds(s.index, kept.shape)))
                for s in kept.shards} == want
    for s in kept.shards:
        assert s.device == kept.mesh.devices[s.position]
        js = jsh[s.position]
        pb, jb = _bounds(s.index, kept.shape), _bounds(js.index, jarr.shape)
        if same_index is True:
            assert pb == jb, (s.position, s.index, js.index)
        elif same_index == "inside":
            assert all(c <= a and b <= d for (a, b), (c, d) in zip(pb, jb))
        else:
            js, jb = jarr, [(0, n) for n in jarr.shape]
        assert tuple(s.data.shape) == tuple(b - a for a, b in pb)
        sub = np.asarray(getattr(js, "data", js))[tuple(slice(a - c, b - c) for (a, b), (c, _)
                                        in zip(pb, jb))]
        if cmp is not None:
            cmp(_np(s.data), sub)
        else:
            np.testing.assert_allclose(_np(s.data), sub, rtol=0,
                                       atol=tol * peak)


def _flips_mass(got, want):
    got, want = np.abs(got), np.abs(want)
    flips = (np.abs(got - want) > 1e-5 * want.max()).mean()
    assert flips <= 5e-3, flips
    assert abs(got.sum() / want.sum() - 1) <= 1e-4


def _same(kept, default):
    """``gather()`` equals the default call bit for bit."""
    assert torch.equal(kept.gather(), default)


# --- the halo-sharded family ------------------------------------------------

@pytest.fixture(scope="module")
def stft_io(mesh, jmesh):
    x = _sig((4, 32768), 1)
    win = j_window(af.WindowType.HANN, FFT)
    Dj = j_sharded.sharded_stft_fn(jmesh, FFT, SLIDE, win)(
        _put(x, jmesh, "data", "time"))
    return x, win, Dj


def test_stft_kept(mesh, jmesh, stft_io):
    x, win, Dj = stft_io
    D = sharded.sharded_stft_fn(mesh, FFT, SLIDE, win, keep_sharded=True)(x)
    assert D.spec == ("data", "time", None)
    assert [s.data.shape[1] for s in D.shards[:4]] == [16, 16, 16, 13]
    _match(D, Dj, jmesh, 1e-4, same_index="inside")
    _same(D, sharded.sharded_stft_fn(mesh, FFT, SLIDE, win)(x))


def test_istft_kept(mesh, jmesh, stft_io):
    x, win, Dj = stft_io
    D = sharded.sharded_stft_fn(mesh, FFT, SLIDE, win)(x)
    y = sharded.sharded_istft_fn(mesh, FFT, SLIDE, win,
                                 keep_sharded=True)(D)
    yj = j_sharded.sharded_istft_fn(jmesh, FFT, SLIDE, win)(Dj)
    _match(y, yj, jmesh, 1e-4)
    _same(y, sharded.sharded_istft_fn(mesh, FFT, SLIDE, win)(D))


@pytest.mark.parametrize("t", [14, 17])
def test_istft_kept_uneven(mesh, stft_io, t):
    """Frame counts whose output does not split evenly: the last part
    holds only the valid samples, or nothing."""
    _, win, _ = stft_io
    rng = np.random.default_rng(t)
    D = (rng.standard_normal((2, t, FFT // 2 + 1))
         + 1j * rng.standard_normal((2, t, FFT // 2 + 1))).astype(np.complex64)
    y = sharded.sharded_istft_fn(mesh, FFT, SLIDE, win,
                                 keep_sharded=True)(D)
    n_out = (t - 1) * SLIDE + FFT
    assert y.shape == (2, n_out)
    assert _bounds(y.shards[-1].index, y.shape)[1][1] == n_out
    _same(y, sharded.sharded_istft_fn(mesh, FFT, SLIDE, win)(D))


@pytest.mark.parametrize("fused", [False, True])
def test_spectrogram_kept(mesh, jmesh, fused):
    kw = dict(num=128, samplate=SR, radix2_exp=11, slide_length=SLIDE)
    jp, tp = af.MelSpectrogram(**kw), aft.MelSpectrogram(**kw, **CPU)
    x = _sig((4, 4 * 512 * 16), 0)
    fkw = dict(with_xxcc=13, fused=fused)
    jkw = dict(fused_tile=8, fused_interpret=True) if fused else {}
    spec, cc = sharded.sharded_spectrogram_fn(tp, mesh, keep_sharded=True,
                                              **fkw)(x)
    jspec, jcc = j_sharded.sharded_spectrogram_fn(jp, jmesh, **fkw, **jkw)(
        _put(x, jmesh, "data", "time"))
    for kept, ja in ((spec, jspec), (cc, jcc)):
        assert kept.spec == ("data", None, "time")
        _match(kept, ja, jmesh, 1e-4, same_index="inside")
    d_spec, d_cc = sharded.sharded_spectrogram_fn(tp, mesh, **fkw)(x)
    _same(spec, d_spec)
    _same(cc, d_cc)


def test_spectrogram_kept_plain_form(mesh):
    plan = aft.MelSpectrogram(num=32, radix2_exp=10, slide_length=256, **CPU)
    x = _sig((2, 4 * 256 * 8), 3)
    kept = sharded.sharded_spectrogram_fn(plan, mesh, keep_sharded=True)(x)
    assert isinstance(kept, ShardedTensor)
    _same(kept, sharded.sharded_spectrogram_fn(plan, mesh)(x))


def test_stats_kept(mesh, jmesh):
    Sx = np.random.default_rng(0).random((4, 16, 64)).astype(np.float32)
    out = features.sharded_spectral_stats_fn(mesh, keep_sharded=True)(Sx)
    jout = j_stats(jmesh)(_put(Sx, jmesh, "data", None, "time"))
    default = features.sharded_spectral_stats_fn(mesh)(Sx)
    for k in ("sum", "mean", "max", "var"):
        assert out[k].spec == ("data", None)
        assert [s.position for s in out[k].shards] == [(0, 0), (1, 0)]
        _match(out[k], jout[k], jmesh, cmp=lambda g, w: np.testing.
               assert_allclose(g, w, rtol=1e-5, atol=1e-6))
        _same(out[k], default[k])


# --- the chains --------------------------------------------------------------

def _no_gather(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a chain gathered")
    for mod in (sharded, features, _shard):
        for name in ("gather", "Assembler"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(ShardedTensor, "gather", refuse)


def test_chain_stft_istft(mesh, jmesh, stft_io, monkeypatch):
    x, win, Dj = stft_io
    want = [sharded.sharded_istft_fn(mesh, FFT, SLIDE, win)(
        sharded.sharded_stft_fn(mesh, FFT, SLIDE, win)(x))]
    _no_gather(monkeypatch)
    D = sharded.sharded_stft_fn(mesh, FFT, SLIDE, win, keep_sharded=True)(x)
    y = sharded.sharded_istft_fn(mesh, FFT, SLIDE, win,
                                 keep_sharded=True)(D)
    yj = j_sharded.sharded_istft_fn(jmesh, FFT, SLIDE, win)(Dj)
    _match(y, yj, jmesh, 1e-4)
    monkeypatch.undo()
    _same(y, want[0])


def test_chain_spectrogram_stats(mesh, jmesh, monkeypatch):
    """Slide 448 with fft 2048 leaves T_valid = 4 * (blocks' slots - 1),
    which JAX's stats need to divide the time axis; the port's stats
    reduce the spectrogram's parts (16, 16, 16, 12 frames) where they
    lie."""
    kw = dict(num=64, samplate=SR, radix2_exp=11, slide_length=448)
    jp, tp = af.MelSpectrogram(**kw), aft.MelSpectrogram(**kw, **CPU)
    x = _sig((4, 4 * 448 * 16), 5)
    _no_gather(monkeypatch)
    spec = sharded.sharded_spectrogram_fn(tp, mesh, keep_sharded=True)(x)
    assert [s.data.shape[-1] for s in spec.shards[:4]] == [16, 16, 16, 12]
    out = features.sharded_spectral_stats_fn(mesh, keep_sharded=True)(spec)
    jspec = j_sharded.sharded_spectrogram_fn(jp, jmesh)(
        _put(x, jmesh, "data", "time"))
    assert jspec.shape[-1] == 60
    jout = j_stats(jmesh)(jspec)
    for k in ("sum", "mean", "max", "var"):
        _match(out[k], jout[k], jmesh, cmp=lambda g, w: np.testing.
               assert_allclose(g, w, rtol=1e-4, atol=1e-6 * np.abs(w).max()))
    monkeypatch.undo()
    ref = features.sharded_spectral_stats_fn(mesh)(
        sharded.sharded_spectrogram_fn(tp, mesh)(x))
    # the two groupings of the frames (16, 16, 16, 12 against 15 a shard)
    # round the sums apart; var = E[S^2] - mean^2 cancels, both groupings
    # 1.4e-5 from float64
    for k, rtol in (("sum", 1e-5), ("mean", 1e-5), ("max", 0.0),
                    ("var", 1e-4)):
        torch.testing.assert_close(out[k].gather(), ref[k], rtol=rtol,
                                   atol=1e-6 * float(ref[k].abs().max()))


def test_global_from_local_feeds_stft(mesh, stft_io):
    x, win, _ = stft_io
    xs = global_from_local(x, mesh, ("data", "time"), keep_sharded=True)
    D = sharded.sharded_stft_fn(mesh, FFT, SLIDE, win, keep_sharded=True)(xs)
    _same(D, sharded.sharded_stft_fn(mesh, FFT, SLIDE, win)(x))


# --- spec and mesh mismatches ----------------------------------------------

def test_mismatched_spec_or_mesh_raises(mesh, stft_io):
    x, win, _ = stft_io
    xt = global_from_local(x, mesh, ("data", "time"), keep_sharded=True)
    cwt = aft.CWT(**CWT_KW, **CPU)
    xc = global_from_local(x[:, :2048], mesh, ("data", "time"),
                           keep_sharded=True)
    with pytest.raises(ValueError, match=r"'data', 'time'.*'data', None"):
        sharded_full.sharded_cwt_fn(cwt, mesh)(xc)
    other = make_mesh(data=1, time=8, devices=[torch.device("cpu")] * 8)
    with pytest.raises(ValueError, match="this function takes"):
        sharded.sharded_stft_fn(other, FFT, SLIDE, win)(xt)
    D = sharded.sharded_stft_fn(mesh, FFT, SLIDE, win, keep_sharded=True)(x)
    with pytest.raises(ValueError, match="spectral stats"):
        features.sharded_spectral_stats_fn(mesh)(D)


# --- the band-sharded family -------------------------------------------------

@pytest.fixture(scope="module")
def cwt_pair():
    return af.CWT(**CWT_KW), aft.CWT(**CWT_KW, **CPU)


@pytest.mark.parametrize("num", [28, 30])
def test_cwt_kept(mesh, jmesh, num):
    kw = dict(CWT_KW, num=num)
    j, t = af.CWT(**kw), aft.CWT(**kw, **CPU)
    x = _sig((2, 2048), 1, 1.0)
    kept = sharded_full.sharded_cwt_fn(t, mesh, keep_sharded=True)(x)
    assert kept.spec == ("data", "time", None)
    jout = j_full.sharded_cwt_fn(j, jmesh, mode="shard_map")(x)
    # at 30 bands JAX's slice of its 32 padded bands re-shards the result
    # (two band parts, each on two devices)
    _match(kept, jout, jmesh, 2e-5, same_index=num == 28)
    _same(kept, sharded_full.sharded_cwt_fn(t, mesh)(x))


def test_pwt_and_cwt_det_kept(mesh, jmesh, cwt_pair):
    j, t = cwt_pair
    x = _sig((2, 2048), 2, 1.0)
    kept = sharded_full.sharded_cwt_fn(t, mesh, det=True, keep_sharded=True)(x)
    _match(kept, j_full.sharded_cwt_fn(j, jmesh, det=True,
                                       mode="shard_map")(x), jmesh, 2e-5)
    jp, tp = af.PWT(num=28, radix2_exp=11), aft.PWT(num=28, radix2_exp=11,
                                                    **CPU)
    kept = sharded_full.sharded_pwt_fn(tp, mesh, keep_sharded=True)(x)
    _match(kept, j_full.sharded_pwt_fn(jp, jmesh, mode="shard_map")(x),
           jmesh, 2e-5)
    _same(kept, sharded_full.sharded_pwt_fn(tp, mesh)(x))


@pytest.mark.parametrize("order", [1, 2])
def test_synsq_reduce_scatter(mesh, jmesh, cwt_pair, order):
    j, t = cwt_pair
    x = _sig((2, 2048), 3, 1.0)
    jsq = af.Synsq(num=28, radix2_exp=11, samplate=SR, order=order)
    tsq = aft.Synsq(num=28, radix2_exp=11, samplate=SR, order=order, **CPU)
    kept = sharded_full.sharded_synsq_fn(t, tsq, mesh, keep_sharded=True)(x)
    assert kept.spec == ("data", None, "time")
    assert [s.data.shape[-1] for s in kept.shards] == [512] * 8
    _same(kept, sharded_full.sharded_synsq_fn(t, tsq, mesh)(x))
    jout = j_full.sharded_synsq_fn(j, jsq, jmesh, mode="shard_map")(x)
    _match(kept, jout, jmesh, cmp=lambda g, w: None)     # the indices
    _flips_mass(_np(kept.gather()), np.asarray(jout))


@pytest.mark.parametrize("order", [1, 2])
def test_wsst_reduce_scatter(mesh, jmesh, order):
    kw = dict(CWT_KW)
    jw, tw = af.WSST(**kw), aft.WSST(**kw, **CPU)
    jw.set_order(order)
    tw.set_order(order)
    x = _sig((2, 2048), 9, 1.0)
    sq, D = sharded_full.sharded_wsst_fn(tw, mesh, keep_sharded=True)(x)
    sq0, D0 = sharded_full.sharded_wsst_fn(tw, mesh)(x)
    _same(sq, sq0)
    _same(D, D0)
    sqj, Dj = j_full.sharded_wsst_fn(jw, jmesh, mode="shard_map")(x)
    _match(D, Dj, jmesh, 2e-5)
    _match(sq, sqj, jmesh, cmp=lambda g, w: None)
    _flips_mass(_np(sq.gather()), np.asarray(sqj))


def test_st_fst_nsgt_kept(mesh, jmesh):
    kw = dict(radix2_exp=10, samplate=SR, min_index=1, max_index=100)
    j, t = af.ST(**kw), aft.ST(**kw, **CPU)
    x = _sig((2, 1024), 4, 1.0)
    kept = sharded_full.sharded_st_fn(t, mesh, keep_sharded=True)(x)
    _match(kept, j_full.sharded_st_fn(j, jmesh, mode="shard_map")(x), jmesh,
           2e-6)
    _same(kept, sharded_full.sharded_st_fn(t, mesh)(x))
    kw = dict(radix2_exp=9, samplate=SR, min_index=1, max_index=200)
    j, t = af.FST(**kw), aft.FST(**kw, **CPU)
    x = _sig((2, 512), 11, 1.0)
    kept = sharded_full.sharded_fst_fn(t, mesh, keep_sharded=True)(x)
    _match(kept, j_full.sharded_fst_fn(j, jmesh, mode="shard_map")(x), jmesh,
           1e-6)
    _same(kept, sharded_full.sharded_fst_fn(t, mesh)(x))
    kw = dict(num=24, radix2_exp=11, samplate=SR, scale_type=S.OCTAVE)
    j, t = af.NSGT(**kw), aft.NSGT(**kw, **CPU)
    x = _sig((2, 2048), 5, 1.0)
    kept = sharded_full.sharded_nsgt_fn(t, mesh, keep_sharded=True)(x)
    _match(kept, j_full.sharded_nsgt_fn(j, jmesh, mode="shard_map")(x), jmesh,
           5e-6)
    _same(kept, sharded_full.sharded_nsgt_fn(t, mesh)(x))


def test_band_family_reads_sharded_rows(mesh, cwt_pair):
    """A ``P(data, None)`` input: each band shard reads its data row from
    the row's first device."""
    _, t = cwt_pair
    x = _sig((2, 2048), 6, 1.0)
    xs = global_from_local(x, mesh, ("data", None), keep_sharded=True)
    assert [s.position for s in xs.shards] == [(0, 0), (1, 0)]
    kept = sharded_full.sharded_cwt_fn(t, mesh, keep_sharded=True)(xs)
    _same(kept, sharded_full.sharded_cwt_fn(t, mesh)(x))


# --- the splice, the batch maps -----------------------------------------------

def test_ccwt_cst_kept(mesh, jmesh, cwt_pair):
    j, t = cwt_pair
    x = _sig((2, 4 * 2048), 7, 1.0)
    kept = sharded_full.sharded_ccwt_fn(t, mesh, keep_sharded=True)(x)
    assert kept.spec == ("data", None, "time")
    _match(kept, j_full.sharded_ccwt_fn(j, jmesh)(x), jmesh, 1e-6)
    _same(kept, sharded_full.sharded_ccwt_fn(t, mesh)(x))
    xs = global_from_local(x, mesh, ("data", "time"), keep_sharded=True)
    _same(sharded_full.sharded_ccwt_fn(t, mesh, keep_sharded=True)(xs),
          kept.gather())
    kw = dict(radix2_exp=10, samplate=SR, min_index=1, max_index=64)
    js, ts = af.ST(**kw), aft.ST(**kw, **CPU)
    x = _sig((2, 4096), 9, 1.0)
    kept = sharded_full.sharded_cst_fn(ts, mesh, keep_sharded=True)(x)
    _match(kept, j_full.sharded_cst_fn(js, jmesh)(x), jmesh, 2e-6)
    _same(kept, sharded_full.sharded_cst_fn(ts, mesh)(x))


def test_batch_maps_kept(mesh, jmesh):
    kw = dict(num=32, samplate=SR, radix2_exp=9, slide_length=128)
    jm, tm = af.MelSpectrogram(**kw), aft.MelSpectrogram(**kw, **CPU)
    x = _sig((4, 4096), 8)
    tf = lambda v: {"s": tm.spectrogram(v), "e": (v * v).sum(-1)}  # noqa
    jf = lambda v: {"s": jm.spectrogram(v), "e": (v * v).sum(-1)}  # noqa
    for t_fn, j_fn in ((sharded_full.sharded_batch_map_fn,
                        j_full.sharded_batch_map_fn),
                       (sharded_full.sharded_batch_fn,
                        j_full.sharded_batch_fn)):
        kept = t_fn(tf, mesh, keep_sharded=True)(x)
        jout = j_fn(jf, jmesh)(x)
        for k in ("s", "e"):
            assert kept[k].spec[0] == "data"
            _match(kept[k], jout[k], jmesh, 1e-4)
            _same(kept[k], t_fn(tf, mesh)(x)[k])
    xs = global_from_local(x, mesh, ("data",), keep_sharded=True)
    kept = sharded_full.sharded_batch_map_fn(tf, mesh, keep_sharded=True)(xs)
    _same(kept["s"], tf(torch.from_numpy(x))["s"])


# --- global_from_local --------------------------------------------------------

@pytest.mark.parametrize("spec,shape", [(("data", "time"), (4, 64)),
                                        (("data", None), (4, 64)),
                                        (("data", None, "time"), (4, 6, 8)),
                                        ((("data", "time"),), (8, 5))])
def test_global_from_local_places_blocks(mesh, jmesh, spec, shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    kept = global_from_local(x, mesh, spec, keep_sharded=True)
    _match(kept, j_gfl(x, jmesh, P(*spec)), jmesh, 0.0)
    assert torch.equal(kept.gather(), torch.from_numpy(x))


# --- the CQT ------------------------------------------------------------------

CQT_KW = dict(num=24, samplate=SR, bin_per_octave=12, low_fre=220.0)


@pytest.fixture(scope="module")
def cqt_pair():
    return af.CQT(**CQT_KW), aft.CQT(**CQT_KW, **CPU)


@pytest.mark.parametrize("batch", [1, 3])
def test_cqt_frame_form(mesh, jmesh, cqt_pair, batch):
    j, t = cqt_pair
    x = _sig((batch, 8192), 6 + batch, 1.0)
    kept = sharded_full.sharded_cqt_fn(t, mesh, mode="gspmd",
                                       keep_sharded=True)(x)
    T = t.cal_time_length(8192)
    assert kept.spec == ("data", None, "time") and kept.shape == (batch, 24, T)
    tl = -(-T // 4)
    for s in kept.shards:                  # each shard only its own frames
        i, jt = s.position
        lo, hi = min(jt * tl, T), min((jt + 1) * tl, T)
        assert _bounds(s.index, kept.shape)[2] == (lo, hi)
        assert s.data.shape[-1] == hi - lo
    rows = [i for i, _ in {s.position for s in kept.shards}]
    assert sorted(set(rows)) == ([0] if batch == 1 else [0, 1])
    got = kept.gather()
    want = t.cqt(x)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=2e-6 * float(want.abs().max()))
    _same(kept, sharded_full.sharded_cqt_fn(t, mesh, mode="gspmd")(x))
    pad = np.concatenate([x, np.repeat(x[-1:], batch % 2, 0)])
    jout = np.asarray(j_full.sharded_cqt_fn(j, jmesh, mode="gspmd")(pad))
    np.testing.assert_allclose(_np(got), jout[:batch], rtol=0,
                               atol=2e-6 * np.abs(jout).max())


def test_cqt_frame_form_sharded_input(mesh, cqt_pair):
    _, t = cqt_pair
    x = _sig((2, 8192), 20, 1.0)
    xs = global_from_local(x, mesh, ("data", "time"), keep_sharded=True)
    got = sharded_full.sharded_cqt_fn(t, mesh, mode="gspmd")(xs)
    assert torch.equal(got, sharded_full.sharded_cqt_fn(t, mesh,
                                                        mode="gspmd")(x))


@pytest.mark.parametrize("batch", [8, 10])
def test_cqt_batch_form_kept(mesh, jmesh, cqt_pair, batch):
    j, t = cqt_pair
    x = _sig((batch, 8192), 30 + batch, 1.0)
    kept = sharded_full.sharded_cqt_fn(t, mesh, keep_sharded=True)(x)
    assert kept.spec == (("data", "time"), None, None)
    _same(kept, sharded_full.sharded_cqt_fn(t, mesh)(x))
    if batch % 8 == 0:
        jout = j_full.sharded_cqt_fn(j, jmesh, mode="shard_map")(x)
        _match(kept, jout, jmesh, 2e-6)
    else:       # array_split's rows: 2, 2, 1, ... a shard
        assert [s.data.shape[0] for s in kept.shards] == [2, 2] + [1] * 6
