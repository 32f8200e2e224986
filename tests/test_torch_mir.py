"""The port's MIR slice (HPSS, YIN pitch) on the CPU (``device="cpu"``)
against the JAX package on the CPU, its Pallas kernels in interpret mode,
and the reference C goldens (the tolerances of tests/test_mir.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.mir.hpss import _hpss_impl as j_hpss_impl
from audioflux_tpu.mir.pitch_yin import _yin_impl as j_yin_impl
from audioflux_tpu.types import WindowType
from audioflux_torch.mir.pitch_yin import _yin_impl as t_yin_impl
from tests.conftest import assert_close_to_golden

SR = 32000
CPU = {"device": "cpu"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def tone():
    t = np.arange(SR) / SR
    return (0.6 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


@pytest.fixture(scope="module")
def mix():
    """1.5 s: a 330 Hz tone, noise bursts every 4000 samples, low noise."""
    rng = np.random.default_rng(11)
    n = 3 * SR // 2
    t = np.arange(n) / SR
    x = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.02 * rng.standard_normal(n)
    for pos in range(2000, n - 2000, 4000):
        x[pos:pos + 64] += 0.8 * rng.standard_normal(64)
    return x.astype(np.float32)


def _hpss_pair(**kw):
    kw = dict(dict(radix2_exp=11, window_type=WindowType.HAMM,
                   slide_length=512, h_order=21, p_order=31), **kw)
    return af.HPSS(**kw), aft.HPSS(**kw, **CPU)


def _yin_kw(plan):
    return dict(fft_length=plan.fft_length, slide_length=plan.slide_length,
                auto_length=plan.auto_length, min_index=plan.min_index,
                max_index=plan.max_index, samplate=float(plan.samplate),
                thresh=plan.thresh)


# ----------------------------------------------------------------- HPSS

def test_hpss_matches_golden_and_jax(goldens):
    g = goldens("mir")
    j, t = _hpss_pair()
    h, p = t.hpss(g["in_x"])
    assert_close_to_golden(_np(h), g["hpss_h"], 5e-5, "hpss_h")
    assert_close_to_golden(_np(p), g["hpss_p"], 5e-5, "hpss_p")
    hj, pj = j.hpss(g["in_x"])
    assert_close_to_golden(_np(h), np.asarray(hj), 1e-4, "h vs jax")
    assert_close_to_golden(_np(p), np.asarray(pj), 1e-4, "p vs jax")
    n = len(g["in_x"])
    assert t.cal_time_length(n) == j.cal_time_length(n)
    assert t.cal_data_length(n) == j.cal_data_length(n) == h.shape[-1]
    assert t.cal_data_length(100) == j.cal_data_length(100) == 0


@pytest.mark.parametrize("orders", [(21, 31), (5, 9)])
def test_hpss_matches_pallas_interpret(mix, orders):
    """Against the JAX kernel path (fft4_fwd, the median kernel, fft4_inv,
    all in Pallas interpret mode) and its default CPU path, 1e-4 of the
    peak."""
    h_order, p_order = orders
    _, t = _hpss_pair(h_order=h_order, p_order=p_order)
    h, p = t.hpss(mix)
    w = jnp.asarray(t.window)
    kw = dict(fft_length=2048, slide_length=512, h_order=h_order,
              p_order=p_order)
    for extra in (dict(use_kernel=True, interpret=True), dict()):
        hj, pj = j_hpss_impl(jnp.asarray(mix), w, **kw, **extra)
        sc = float(np.max(np.abs(mix)))
        assert np.max(np.abs(_np(h) - np.asarray(hj))) / sc <= 1e-4, extra
        assert np.max(np.abs(_np(p) - np.asarray(pj))) / sc <= 1e-4, extra
    # the tone goes to h, the bursts to p
    burst = slice(2000 + 4000 * 3, 2000 + 4000 * 3 + 64)
    assert np.abs(_np(p)[burst]).max() > 0.2
    quiet = slice(2000 + 4000 * 3 + 1500, 2000 + 4000 * 3 + 2500)
    assert np.abs(_np(p)[quiet]).max() < 0.2 * np.abs(_np(h)[quiet]).max()


def test_hpss_batched_equals_single_and_other_sizes(goldens, mix):
    x = goldens("mir")["in_x"]
    j, t = _hpss_pair()
    h, p = t.hpss(np.stack([x, 0.5 * x]))
    hs, ps = t.hpss(x)
    assert h.shape == (2, hs.shape[-1])
    np.testing.assert_allclose(_np(h)[0], _np(hs), atol=3e-6)
    np.testing.assert_allclose(_np(p)[0], _np(ps), atol=3e-6)
    np.testing.assert_allclose(_np(h)[1], 0.5 * _np(hs), atol=3e-6)
    # an fft_length outside the kernels' domain (torch.fft's tier), a slide
    # that does not divide it, and the default slide
    for kw in (dict(radix2_exp=10, slide_length=300),
               dict(radix2_exp=9, slide_length=0)):
        j, t = _hpss_pair(**kw)
        assert t.slide_length == j.slide_length
        (h, p), (hj, pj) = t.hpss(mix), j.hpss(mix)
        assert_close_to_golden(_np(h), np.asarray(hj), 1e-4, str(kw))
        assert_close_to_golden(_np(p), np.asarray(pj), 1e-4, str(kw))
    for bad in (dict(h_order=4), dict(p_order=0), dict(h_order=-3)):
        with pytest.raises(ValueError):
            aft.HPSS(**bad, **CPU)


def test_hpss_load_reference_window(mix):
    j, t = _hpss_pair()
    w = (j.window * np.linspace(0.5, 1.0, 2048)).astype(np.float32)
    j.window = w
    aft.load_reference_constants(t, window=w)
    (h, p), (hj, pj) = t.hpss(mix), j.hpss(mix)
    assert_close_to_golden(_np(h), np.asarray(hj), 1e-4, "h")
    assert_close_to_golden(_np(p), np.asarray(pj), 1e-4, "p")
    with pytest.raises(ValueError):
        aft.load_reference_constants(t, window=w[:100])


# ------------------------------------------------------------------ YIN

def test_yin_matches_golden_and_jax(goldens, tone):
    g = goldens("mir")
    j = af.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024)
    t = aft.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024, **CPU)
    fre, val = t.pitch(tone)
    np.testing.assert_allclose(_np(fre), g["yin_fre"], atol=5e-3)
    np.testing.assert_allclose(_np(val), g["yin_val"], atol=1e-5)
    assert abs(np.median(_np(fre)) - 440.0) < 1.0
    fj, vj = j.pitch(tone)
    np.testing.assert_allclose(_np(fre), np.asarray(fj), atol=5e-3)
    np.testing.assert_allclose(_np(val), np.asarray(vj), atol=1e-5)
    np.testing.assert_allclose(t.get_min_data(), j.get_min_data(), atol=1e-5)
    assert t.cal_time_length(SR) == j.cal_time_length(SR) == fre.shape[-1]
    assert t.cal_time_length(100) == 0


def test_yin_packed_form_matches_rfft_form(tone):
    """The card's packed autocorrelation (Im(ifft(fft(x + i*rev)^2))/2),
    forced on here on the CPU, equals the two-rfft form to float
    rounding (tests/test_mir.py's tolerances)."""
    rng = np.random.default_rng(3)
    x = np.stack([tone, tone[::-1] + 0.01 * rng.standard_normal(SR)
                  .astype(np.float32)])
    t = aft.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024, **CPU)
    f0, v0, y0, _ = t._run(x, packed_fft=False)
    f1, v1, y1, _ = t._run(x, packed_fft=True)
    np.testing.assert_allclose(_np(y1), _np(y0), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(f1), _np(f0), atol=1e-2)
    np.testing.assert_allclose(_np(v1), _np(v0), atol=1e-4)
    # the default on a CPU tensor is the rfft form
    fd, _, yd, _ = t._run(x)
    assert np.array_equal(_np(yd), _np(y0))
    # packed, outside the FFT kernels' domain (ops.fft's torch.fft tier)
    t10 = aft.PitchYIN(samplate=SR, radix2_exp=10, slide_length=256,
                       auto_length=512, **CPU)
    _, _, ya, _ = t10._run(x[:, :8000], packed_fft=False)
    _, _, yb, _ = t10._run(x[:, :8000], packed_fft=True)
    np.testing.assert_allclose(_np(yb), _np(ya), atol=2e-4, rtol=2e-4)


def test_yin_matches_pallas_interpret():
    """Against the JAX package's packed form with the fused
    fft4_autocorr Pallas kernel in interpret mode, radix2_exp 11.  The
    Pallas kernel's products carry its 5e-5-of-peak contract into the CMND
    curve, so the curve is held at the 2e-3 of tests/test_pallas_fft.py;
    against the JAX rfft form it is held at 2e-4."""
    t_ax = np.arange(SR // 2, dtype=np.float32) / SR
    x = (0.6 * np.sin(2 * np.pi * 220 * t_ax)
         + 0.2 * np.sin(2 * np.pi * 440 * t_ax)).astype(np.float32)
    plan = aft.PitchYIN(samplate=SR, radix2_exp=11, slide_length=512,
                        auto_length=1024, **CPU)
    kw = _yin_kw(plan)
    f1, v1, y1, i1 = t_yin_impl(torch.from_numpy(x), packed_fft=True, **kw)
    fk, vk, yk, ik = j_yin_impl(jnp.asarray(x), packed_fft=True,
                                use_fft_kernel=True, interpret=True, **kw)
    np.testing.assert_allclose(_np(y1), np.asarray(yk), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(f1), np.asarray(fk), rtol=1e-4)
    fr, vr, yr, ir = j_yin_impl(jnp.asarray(x), packed_fft=False, **kw)
    np.testing.assert_allclose(_np(y1), np.asarray(yr), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(f1), np.asarray(fr), atol=1e-2)
    np.testing.assert_allclose(_np(v1), np.asarray(vr), atol=1e-4)


def test_yin_trough_data_and_equal_troughs(tone):
    j = af.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024)
    t = aft.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024, **CPU)
    x = (tone[:12000] + 0.3 * np.sin(2 * np.pi * 660 * np.arange(12000) / SR)
         ).astype(np.float32)
    fj, tj, lj = j.get_trough_data(x)
    ft, tt, lt = t.get_trough_data(x)
    assert np.array_equal(lt, lj) and lt.sum() > 0
    for a, b in zip(ft + tt, fj + tj):
        np.testing.assert_allclose(a, b, atol=5e-3)
    with pytest.raises(ValueError):
        t.get_trough_data(np.stack([x, x]))
    # two equal troughs in one row: the first one is picked, as jnp.argmax
    # picks it; a plateau's first cell is the trough (<= next, < previous)
    rows = np.full((3, 40), 0.5, np.float32)
    rows[0, [10, 20]] = 0.05                  # two equal isolated troughs
    rows[1, 12:15] = 0.03                     # a plateau
    rows[2, 0] = 0.01                         # the first column, strict rise
    rows[2, 39] = 0.001                       # the last column never counts
    below = rows < 0.1
    trough = np.concatenate(
        [(rows[:, :1] < rows[:, 1:2]) & below[:, :1],
         (rows[:, 1:-1] <= rows[:, 2:]) & (rows[:, 1:-1] < rows[:, :-2])
         & below[:, 1:-1], np.zeros((3, 1), bool)], axis=1)
    assert np.array_equal(np.asarray(jnp.argmax(jnp.asarray(trough), axis=-1)),
                          [10, 12, 0])
    got = torch.argmax(torch.from_numpy(trough).to(torch.uint8), dim=-1)
    assert got.tolist() == [10, 12, 0]


def test_yin_two_equal_troughs_end_to_end():
    """A frame whose CMND curve has two equal minima: both packages pick
    the same (first) one.  A pulse train of period 64 gives exact repeats
    at lags 64, 128, ..."""
    x = np.zeros(3 * 4096, np.float32)
    x[::64] = 1.0
    j = af.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024)
    t = aft.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024, **CPU)
    fj, vj = j.pitch(x)
    ft, vt = t.pitch(x)
    yin = _np(t._yin_mat)
    lows = (yin < 0.1).sum(axis=-1)
    assert lows.min() >= 2                      # several troughs per frame
    np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=5e-3)
    np.testing.assert_allclose(_np(ft), SR / 64.0, atol=0.5)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(low_fre=5.0), dict(high_fre=20000.0), dict(high_fre=20.0),
    dict(auto_length=5000), dict(auto_length=-1), dict(slide_length=0),
    dict(radix2_exp=11, auto_length=1024, low_fre=27.0),
    dict(samplate=16000, high_fre=4000.0),
])
def test_yin_constructor_clamps(kw):
    j, t = af.PitchYIN(**kw), aft.PitchYIN(**kw, **CPU)
    for name in ("samplate", "low_fre", "high_fre", "fft_length",
                 "slide_length", "auto_length", "min_index", "max_index",
                 "thresh"):
        assert getattr(t, name) == getattr(j, name), name
    for plan in (j, t):
        plan.set_thresh(0.25)
        plan.set_thresh(-1.0)
    assert t.thresh == j.thresh == 0.25


def test_yin_batched(tone):
    t = aft.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024, **CPU)
    fre, val = t.pitch(np.stack([tone, tone]).reshape(2, 1, -1))
    single_fre, single_val = t.pitch(tone)
    assert fre.shape == (2, 1, single_fre.shape[0])
    np.testing.assert_allclose(_np(fre)[0, 0], _np(single_fre), rtol=1e-6)
    np.testing.assert_allclose(_np(val)[1, 0], _np(single_val), atol=1e-6)


# --------------------------------------------------------------- policy

def test_mir_device_policy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (aft.HPSS, aft.PitchYIN,
                 lambda: aft.HPSS(device="cuda"),
                 lambda: aft.PitchYIN(device="cuda:0")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for plan, call in ((aft.HPSS(radix2_exp=11, **CPU), "hpss"),
                       (aft.PitchYIN(**CPU), "pitch")):
        assert plan.device == torch.device("cpu")
        with pytest.raises(ValueError):
            getattr(plan, call)(torch.zeros(8192, device="meta"))


# ------------------------------------------------------ the whole slice

def test_mir_slice_end_to_end(mix):
    """One clip through HPSS, then YIN on the harmonic part, in both
    packages on the CPU."""
    jh, th = _hpss_pair()
    jy = af.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024)
    ty = aft.PitchYIN(samplate=SR, radix2_exp=12, slide_length=1024, **CPU)
    h_j, p_j = jh.hpss(mix)
    h_t, p_t = th.hpss(mix)
    assert_close_to_golden(_np(h_t), np.asarray(h_j), 1e-4, "h")
    assert_close_to_golden(_np(p_t), np.asarray(p_j), 1e-4, "p")
    f_j, v_j = jy.pitch(np.asarray(h_j))
    f_t, v_t = ty.pitch(h_t)                    # a tensor on the plan's device
    np.testing.assert_allclose(_np(ty._yin_mat), np.asarray(jy._yin_mat),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(f_t), np.asarray(f_j), atol=1e-2)
    np.testing.assert_allclose(_np(v_t), np.asarray(v_j), atol=1e-4)
    voiced = _np(f_t) > 0
    assert voiced.mean() > 0.8
    assert abs(np.median(_np(f_t)[voiced]) - 330.0) < 1.0
    # and the STFT round trip of the harmonic part
    js = af.STFT(radix2_exp=11, window_type=WindowType.HANN, slide_length=512)
    ts = aft.STFT(radix2_exp=11, window_type=WindowType.HANN,
                  slide_length=512, **CPU)
    D = ts.stft(h_t)
    assert_close_to_golden(_np(D).real, np.asarray(js.stft(h_j)).real, 1e-4,
                           "stft of h")
    back = _np(ts.istft(D))
    n = back.shape[-1]
    assert np.abs(back - _np(h_t)[:n])[2048:-2048].max() < 1e-4
