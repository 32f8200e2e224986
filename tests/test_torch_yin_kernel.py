"""YIN from the clips to the pitch in one kernel (``ops.cuda_yin``,
``csrc/fft_pow2.cu`` ``yin_reg_kernel``): which calls take it, the
wrapper's checks and its CPU policy, the parabolic offsets that
``get_trough_data`` derives from the CMND rows, and the kernel's epilogue
as an index model held against the plain version; on the card (marker
``card``), the kernel against the port's PyTorch path.

The kernel cannot run without the card, so what can go wrong in its
epilogue before any rounding does — which thread holds which square, lag
and column, which prefix values give the energies, which lags feed the
difference function and the CMND, the first-trough rule across the
group's threads — is mirrored here with the kernel's own index formulas
in float64 and held against ``yin_tail`` in float64.

The card tests import no JAX and need no conftest: run them on the card
with ``python3 -m pytest --noconftest -m card
tests/test_torch_yin_kernel.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audioflux_torch.mir import pitch_yin
from audioflux_torch.ops import _build, cuda_fft, cuda_yin
from audioflux_torch.ops.frame import frame_signal

_SPLIT = {2048: (64, 32), 4096: (64, 64)}   # csrc/fft_pow2.cu launch_yin
SR = 32000


def _signal(shape, seed=0, f0=440.0):
    """A tone with an overtone and a little noise: real troughs."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SR
    x = (0.4 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(4 * np.pi * f0 * t)
         + 0.01 * rng.standard_normal(shape))
    return x.astype(np.float32)


def _plan(radix2_exp, slide, auto, low=27.0, high=2000.0, thresh=0.1):
    p = pitch_yin.PitchYIN(samplate=SR, low_fre=low, high_fre=high,
                           radix2_exp=radix2_exp, slide_length=slide,
                           auto_length=auto, device="cpu")
    p.set_thresh(thresh)
    return p


# ------------------------------------------------------------ the route

@pytest.mark.parametrize("is_cuda,dtype,n,mn,mx,want", [
    (True, torch.float32, 4096, 16, 1186, True),    # the benchmark's plan
    (True, torch.float32, 2048, 16, 1023, True),
    (True, torch.float32, 2048, 1, 3, True),         # three columns, lag 1
    (True, torch.float32, 2048, 5, 6, False),        # two columns
    (True, torch.float32, 2048, 0, 10, False),       # a column at lag 0
    (True, torch.float32, 1024, 16, 511, False),     # not a kernel length
    (True, torch.float32, 8192, 16, 1186, False),
    (True, torch.float64, 4096, 16, 1186, False),
    (False, torch.float32, 4096, 16, 1186, False),   # the CPU
])
def test_route_choice(is_cuda, dtype, n, mn, mx, want):
    x = SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    assert cuda_yin.supports(x, n, mn, mx) == want


def test_pitch_routes_a_cpu_call_to_yin_impl(monkeypatch):
    """On the CPU ``PitchYIN.pitch`` runs ``_yin_impl`` (the JAX-parity
    path, rfft form) and never the wrapper."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call took the kernel's wrapper")
    monkeypatch.setattr(cuda_yin, "yin_pitch", refuse)
    p = _plan(12, 1024, 2048)
    x = _signal((2, 12000))
    fre, value = p.pitch(x)
    want = p._run(x)
    assert torch.equal(fre, want[0]) and torch.equal(value, want[1])
    assert torch.equal(p._yin_mat, want[2])


# ---------------------------------------------- the wrapper on the CPU

def test_cpu_policy_and_checks(monkeypatch):
    """A CPU tensor takes the plain version, ``_yin_impl``'s tail on the
    packed autocorrelation bit for bit, and never builds."""
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    x = torch.from_numpy(_signal((3, 9000)))
    p = _plan(11, 512, 1024)
    plan = p._plan()
    before = cuda_yin.yin_pitch.launches
    fre, value, yin = cuda_yin.yin_pitch(x, **plan)
    assert cuda_yin.yin_pitch.launches == before
    assert fre.shape == value.shape == (3, 14)
    assert yin.shape == (3, 14, p.max_index - p.min_index + 1)
    frames = frame_signal(x, 2048, 512)
    acf = cuda_fft.fft_autocorr_yin_ref(x, 2048, 512, 1024)
    kw = {k: plan[k] for k in ("auto_length", "min_index", "max_index",
                               "samplate", "thresh")}
    want = cuda_yin.yin_tail(frames, acf, **kw)
    for got, w in zip((fre, value, yin), want):
        assert torch.equal(got, w)
    # the same tail as _yin_impl's packed form on the CPU
    impl = pitch_yin._yin_impl(x, **plan, packed_fft=True)
    for got, w in zip((fre, value, yin), impl):
        assert torch.equal(got, w)
    assert (fre > 0).float().mean() > 0.5     # the tone is found


@pytest.mark.parametrize("change,err", [
    (dict(fft_length=1024), ValueError),
    (dict(fft_length=8192), ValueError),
    (dict(auto_length=2048), ValueError),
    (dict(slide_length=0), ValueError),
    (dict(min_index=0), ValueError),
    (dict(min_index=20, max_index=21), ValueError),
    (dict(max_index=1024), ValueError),        # past n - auto_length - 1
    (dict(samples=2000), ValueError),          # no frame
    (dict(dtype=torch.float64), TypeError),
])
def test_wrapper_checks(change, err):
    plan = dict(fft_length=2048, slide_length=512, auto_length=1024,
                min_index=16, max_index=1023, samplate=float(SR), thresh=0.1)
    samples = change.pop("samples", 5000)
    dtype = change.pop("dtype", torch.float32)
    plan.update(change)
    x = torch.zeros(2, samples, dtype=dtype)
    with pytest.raises(err):
        cuda_yin.yin_pitch(x, **plan)


def test_wrapper_takes_the_last_lag():
    """max_index = n - auto_length - 1, the last lag there is."""
    x = torch.from_numpy(_signal((5000,)))
    fre, value, yin = cuda_yin.yin_pitch(
        x, fft_length=2048, slide_length=512, auto_length=1024, min_index=16,
        max_index=1023, samplate=float(SR), thresh=0.1)
    assert yin.shape == (6, 1008) and fre.shape == (6,)


@pytest.mark.parametrize("thresh", [0.1, 0.6])
def test_trough_data_derives_the_offsets_yin_impl_returns(thresh):
    """``get_trough_data`` derives its offsets from the cached CMND rows;
    on the CPU they equal ``_yin_impl``'s ``interp`` bit for bit, so the
    trough lists are those the offsets of ``_yin_impl`` give."""
    p = _plan(12, 1024, 2048, thresh=thresh)
    x = _signal((40000,), seed=3, f0=220.0)
    _, _, yin, interp = p._run(x)
    assert torch.equal(cuda_yin.parabolic_offsets(yin), interp)
    fre_rows, trough_rows, lens = p.get_trough_data(x)
    assert lens.sum() > 0
    yin_np, interp_np = yin.numpy(), interp.numpy()
    for i, (fres, vals) in enumerate(zip(fre_rows, trough_rows)):
        a = yin_np[i]
        cols = [j for j in range(len(a) - 1)
                if a[j] < p.thresh and (a[0] < a[1] if j == 0 else
                                        a[j] <= a[j + 1] and a[j] < a[j - 1])]
        assert len(cols) == lens[i]
        want = [p.samplate / (p.min_index + j + float(interp_np[i, j]))
                for j in cols]
        assert np.array_equal(fres, np.asarray(want, np.float32))
        assert np.array_equal(vals, a[cols])


# ---------------------------------------------- the epilogue's index model

def _pad(i, B):
    """The transpose buffer's word of point i: rows of B at pitch B + 1."""
    return (i // B) * (B + 1) + i % B


def _exclusive(sums):
    return np.concatenate([[0.0], np.cumsum(sums)[:-1]])


def _first_trough_model(col, thresh, T):
    """The trough search as the group runs it: thread t the columns t,
    t + T, ..., its first hit kept; the group's least."""
    L = len(col)
    firsts = []
    for t in range(T):
        first = L
        for c in range(t, L, T):
            if first == L and c < L - 1 and col[c] < thresh and (
                    col[c] < col[1] if c == 0
                    else col[c] <= col[c + 1] and col[c] < col[c - 1]):
                first = c
        firsts.append(first)
    return min(firsts)


def _offset(v1, v2, v3):
    off = -(v3 - v1) / 2.0 / (2.0 * ((v1 + v3 - 2 * v2) / 2.0) + 1e-16)
    return off if abs(off) <= 1.0 else 0.0


def _epilogue_model(frame, acf, n, lag, mn, mx, thresh):
    """``yin_reg_kernel`` past the transform on one frame (float64): the
    squares as the load loop writes them, the energies' runs and scan, the
    difference function from the lags the inverse leaves with each thread,
    the CMND's odd runs, the trough.  Asserts every word is written once
    where the kernel writes it once.  Returns (fre, value, yin row)."""
    A, B = _SPLIT[n]
    T, P = B, B + 1
    ex = np.full(A * P, np.nan)
    for t in range(T):               # the load loop: point t + B j
        for j in range(A):
            i = t + B * j
            assert _pad(i, B) == j * P + t and np.isnan(ex[j * P + t])
            ex[j * P + t] = frame[i] * frame[i]
    # thread t's run [t A, t A + A): in order, started by the group's scan
    runs = [[_pad(t * A + m, B) for m in range(A)] for t in range(T)]
    assert sorted(w for r in runs for w in r) == sorted(
        _pad(i, B) for i in range(n))
    if B == 64:                      # a warp's reads in distinct banks
        for m in range(A):
            assert len({runs[t][m] % 32 for t in range(32)}) == 32
    base = _exclusive([sum(ex[w] for w in r) for r in runs])
    for t in range(T):
        run = base[t]
        for w in runs[t]:
            run += ex[w]
            ex[w] = run
    csum = np.array([ex[_pad(i, B)] for i in range(n)])
    en = np.full(mx + 1, np.nan)
    for t in range(T):
        for k in range(t, mx + 1, T):
            e = csum[lag + k] - csum[k]
            en[k] = e if abs(e) >= 1e-6 else 0.0
    assert not np.isnan(en).any()
    # the difference function: the inverse leaves lag i = t + B j1 with
    # thread t; acf[k] is lag lag + k
    ex = np.full(A * P, np.nan)
    for t in range(T):
        for j1 in range(A):
            k = t + B * j1 - lag
            if 0 <= k <= mx:
                assert np.isnan(ex[k])
                a = acf[k] if abs(acf[k]) >= 1e-6 else 0.0
                ex[k] = (en[0] + en[k]) - 2.0 * a
    assert not np.isnan(ex[:mx + 1]).any() and np.isnan(ex[mx + 1:]).all()
    # the CMND: odd runs of ch lags from 1 + t ch
    ch = ((mx + T - 1) // T) | 1
    spans = [(1 + t * ch, min(1 + t * ch + ch, mx + 1)) for t in range(T)]
    assert [k for a, b in spans for k in range(a, b)] == list(
        range(1, mx + 1))
    for w in range(0, T, 32):
        assert len({(1 + t * ch) % 32 for t in range(w, w + 32)}) == 32
    base = _exclusive([ex[a:b].sum() for a, b in spans])
    for t, (a, b) in enumerate(spans):
        run = base[t]
        for k in range(a, b):
            d = ex[k]
            run += d
            if k >= mn:
                ex[k] = d / (run / k + 1e-16)
    col = ex[mn:mx + 1].copy()
    first = _first_trough_model(col, thresh, T)
    if first == len(col):
        return 0.0, 0.0, col
    off = 0.0 if first == 0 else _offset(*col[first - 1:first + 2])
    return 1.0 / (mn + first + off) * SR, col[first], col


MODEL_CASES = [
    # n, slide, auto_length, min_index, max_index, thresh
    (2048, 512, 1024, 16, 1023, 0.1),
    (4096, 1024, 2048, 16, 1186, 0.1),     # the benchmark's plan
    (4096, 1024, 2048, 16, 1186, 0.6),     # TuneTrack's threshold
    (2048, 300, 0, 1, 3, 0.5),             # three columns from lag 1
    (4096, 777, 100, 5, 3995, 0.2),        # the last lag there is
]


@pytest.mark.parametrize("n,slide,lag,mn,mx,thresh", MODEL_CASES)
def test_epilogue_index_model(n, slide, lag, mn, mx, thresh):
    """The kernel's epilogue, index for index in float64, against
    ``yin_tail`` in float64 on the same frames and lags: equal to 1e-9
    (only the order of the sums differs)."""
    x = _signal((2 * n + slide,), seed=n + lag, f0=330.0).astype(np.float64)
    x[n:n + slide] *= 0.0                  # a quieter stretch
    xt = torch.from_numpy(x)
    frames = frame_signal(xt, n, slide)
    acf = cuda_fft.fft_autocorr_yin_ref(xt, n, slide, lag)
    fre, value, yin, _ = cuda_yin.yin_tail(
        frames, acf, auto_length=lag, min_index=mn, max_index=mx,
        samplate=float(SR), thresh=thresh)
    for f in range(frames.shape[0]):
        mf, mv, mrow = _epilogue_model(frames[f].numpy(), acf[f].numpy(), n,
                                       lag, mn, mx, thresh)
        np.testing.assert_allclose(mrow, yin[f].numpy(), rtol=1e-9,
                                   atol=1e-12)
        assert (mf == 0) == (fre[f].item() == 0)
        np.testing.assert_allclose(mf, fre[f].item(), rtol=1e-9)
        np.testing.assert_allclose(mv, value[f].item(), rtol=1e-9,
                                   atol=1e-12)


def _rows(*cols, L=70, fill=0.9):
    """CMND rows of L columns at ``fill``, with (column, value) pairs."""
    out = []
    for pairs in cols:
        row = np.full(L, fill)
        for c, v in pairs:
            row[c] = v
        out.append(row)
    return torch.tensor(np.asarray(out))


TROUGHS = {
    "first column": [(0, 0.05), (1, 0.2)],
    "first column, a flat start": [(0, 0.05), (1, 0.05), (2, 0.01)],
    "interior": [(9, 0.3), (10, 0.05), (11, 0.2)],
    "interior, flat after": [(10, 0.05), (11, 0.05)],
    "interior, flat before": [(9, 0.05), (10, 0.05), (11, 0.2)],
    "last column only": [(69, 0.01)],
    "none below": [(10, 0.15)],
    "two threads, the lower column wins": [(37, 0.02), (5, 0.08)],
    "a thread's second column after another's first": [(64, 0.01),
                                                       (33, 0.09)],
}


@pytest.mark.parametrize("B", [32, 64])
def test_first_trough_rule(B):
    """The group's search (each thread's first hit, then the least) picks
    the column ``first_trough`` picks: the first column with a strict rise
    after it, an interior column with a strict fall before and no fall
    after, never the last column; none where no column qualifies."""
    yin = _rows(*TROUGHS.values())
    interp = cuda_yin.parabolic_offsets(yin)
    fre, value = cuda_yin.first_trough(yin, interp, min_index=16,
                                       samplate=float(SR), thresh=0.1)
    for r, name in enumerate(TROUGHS):
        col = yin[r].numpy()
        first = _first_trough_model(col, 0.1, B)
        if first == len(col):
            assert fre[r] == 0 and value[r] == 0, name
        else:
            off = interp[r, first].item()
            assert fre[r].item() == pytest.approx(SR / (16 + first + off),
                                                  rel=1e-12), name
            assert value[r].item() == col[first], name
    want = [0, 2, 10, 10, 9, None, None, 5, 33]
    got = [_first_trough_model(yin[r].numpy(), 0.1, B)
           for r in range(len(TROUGHS))]
    assert got == [70 if w is None else w for w in want]


# ----------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda:0")


FLIP = 0.01            # a frame whose pitch moves by more than 1% flipped
FLIP_SHARE = 2e-4      # mir.corpus's pitch_flips limit
# |yin - plain| over max(1, |plain|): the difference function cancels near
# a period (e2[0] + e2[k] - 2 acf[k], each term ~100x the result), so the
# two sums' orders part by up to 2.2e-5 over 8 x 300 s of the benchmark's
# traffic (PERF.md)
YIN_TOL = 1e-4


def _cmnd_condition(x, plan):
    """How far the CMND's float32 sums amplify rounding at each column:
    sum |d_i| over |sum d_i|, lags 1..k, of the difference function d
    (float64).  1 where d >= 0, as YIN's d of a window of many samples
    is; large where d changes sign (a window of one sample: auto_length
    0) and the running mean cancels."""
    n, slide, auto = (plan[k] for k in ("fft_length", "slide_length",
                                        "auto_length"))
    mn, mx = plan["min_index"], plan["max_index"]
    x = x.double()
    frames = frame_signal(x, n, slide)
    acf = cuda_fft.fft_autocorr_yin_ref(x, n, slide, auto)
    csum = torch.cumsum(frames * frames, dim=-1)
    e2 = csum[..., auto:] - csum[..., :n - auto]
    d = (e2[..., :1] + e2 - 2.0 * acf)[..., 1:mx + 1]
    cond = torch.cumsum(d.abs(), -1) / torch.cumsum(d, -1).abs()
    return cond[..., mn - 1:].clamp(min=1.0).nan_to_num(1.0, 1.0).float()


def _hold(label, got, want, cond=1.0):
    """The kernel's (fre, value, yin) against the plain path's: the CMND
    rows within float32 rounding (scaled by the sums' ``cond``ition), the
    pitch and value equal but on a knife edge's frames, at most
    FLIP_SHARE of them."""
    fre, value, yin = got
    wf, wv, wy = want
    err = ((yin - wy).abs() / wy.abs().clamp(min=1.0) / cond).max().item()
    flips = ((fre - wf).abs() > FLIP * wf.abs()) | ((fre == 0) != (wf == 0))
    share = flips.float().mean().item()
    keep = ~flips
    fre_err = ((fre - wf).abs() / wf.abs().clamp(min=1.0))[keep].max().item()
    val_err = ((value - wv).abs() / wv.abs().clamp(min=1.0))[keep].max().item()
    print(f"{label}: yin {err:.3e}, flips {int(flips.sum())} of "
          f"{flips.numel()}, fre {fre_err:.3e}, value {val_err:.3e}")
    assert err <= YIN_TOL, label
    assert share <= FLIP_SHARE, label
    assert fre_err <= 1e-4 and val_err <= YIN_TOL, label


# At auto_length 0 the difference function is -2 x[0] x[k] (no energies):
# every CMND sum cancels and the float32 CMND is noise, on either path, so
# that case is held by the index model above; the card takes a window of
# 64 samples.
CARD_CASES = [
    # radix2_exp, slide, auto_length, shape
    (11, 512, 1024, (2, 9000)),
    (12, 1024, 2048, (2, 13000)),
    (11, 300, 64, (20011,)),
    (12, 777, 100, (3, 2, 9001)),
]


@pytest.mark.card
@pytest.mark.parametrize("r2e,slide,auto,shape", CARD_CASES)
def test_kernel_matches_the_plain_path_on_the_card(card, r2e, slide, auto,
                                                   shape):
    """At 2048 and 4096, short and long windows, 1-D to 3-D input: the
    kernel against ``_yin_impl`` on the card and the plain version; the
    same bits from call to call."""
    p = _plan(r2e, slide, auto)
    plan = p._plan()
    x = torch.from_numpy(_signal(shape, seed=r2e + auto)).to(card)
    got = cuda_yin.yin_pitch(x, **plan)
    cond = _cmnd_condition(x, plan)
    _hold(f"{r2e} {slide} {auto} {shape} vs _yin_impl", got,
          pitch_yin._yin_impl(x, **plan)[:3], cond)
    _hold(f"{r2e} {slide} {auto} {shape} vs plain", got,
          cuda_yin.yin_pitch_ref(x, **plan), cond)
    again = cuda_yin.yin_pitch(x, **plan)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.card
def test_kernel_at_the_benchmarks_plan_on_the_card(card):
    """One 5-minute recording of the benchmark's traffic with its plan:
    ``PitchYIN.pitch`` launches the kernel once and no autocorrelation,
    and holds to the plain path."""
    from benchmark import traffic
    x = traffic.mir((1, 300 * SR), traffic.generator(3100002301, card), card,
                    SR)
    p = pitch_yin.PitchYIN(samplate=SR, low_fre=27.0, high_fre=2000.0,
                           radix2_exp=12, slide_length=1024, auto_length=2048,
                           device=card)
    p.set_thresh(0.1)
    before = (cuda_yin.yin_pitch.launches, cuda_fft.fft_autocorr_yin.launches)
    fre, value = p.pitch(x)
    torch.cuda.synchronize(card)
    after = (cuda_yin.yin_pitch.launches, cuda_fft.fft_autocorr_yin.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 0]
    assert fre.shape == (1, 9372) and p._yin_mat.shape == (1, 9372, 1171)
    _hold("benchmark plan vs _yin_impl", (fre, value, p._yin_mat),
          pitch_yin._yin_impl(x, **p._plan())[:3])
    assert (fre > 0).float().mean().item() > 0.5


@pytest.mark.card
def test_tune_track_unchanged_on_the_card(card, monkeypatch):
    """TuneTrack (threshold 0.6, the CMND minimum and the trough lists too)
    tracks the same pitch through the kernel as through ``_yin_impl``."""
    from audioflux_torch.track.tune_track import TuneTrack
    from benchmark import traffic
    x = traffic.mir((1, 20 * SR), traffic.generator(3100002302, card), card,
                    SR)[0].cpu().numpy()
    before = cuda_yin.yin_pitch.launches
    kernel = TuneTrack(device=card)
    got = kernel.tune(x)
    assert cuda_yin.yin_pitch.launches == before + 1
    mins = kernel._yin.get_min_data()
    troughs = kernel._yin.get_trough_data()
    monkeypatch.setattr(cuda_yin, "supports", lambda *a: False)
    plain = TuneTrack(device=card)
    want = plain.tune(x)
    assert cuda_yin.yin_pitch.launches == before + 1
    moved = np.abs(got - want) > FLIP * np.abs(want)
    print(f"TuneTrack: {int(moved.sum())} of {moved.size} frames moved; "
          f"{int((want > 0).sum())} tracked")
    assert moved.mean() <= FLIP_SHARE
    np.testing.assert_allclose(mins, plain._yin.get_min_data(), rtol=YIN_TOL,
                               atol=YIN_TOL)
    assert np.array_equal(troughs[2], plain._yin.get_trough_data()[2])
