"""PEF from the recordings to the pitch in two kernels (``ops.cuda_pef``,
``csrc/pef.cu``): which calls take them, the wrappers' checks and their
CPU policy, and the kernels' epilogues as index models held against the
plain versions; on the card (marker ``card``), the kernels against the
port's PyTorch path.

The kernels cannot run without the card, so what can go wrong past their
transforms before any rounding does — which pairs of the front's split
hold the bins the log grid reads, which thread writes each kept bin, the
back's exchange of Z[N - k] through the transpose buffer and its banks,
the split, the product with conj(Ff) and the merge of the half spectrum
at each bin a thread holds, which lags the inverse leaves with which
thread, and the arg-max across threads, warps and ties — is mirrored here
with the kernels' own index formulas in float64 and held against the
plain versions in float64.

The card tests import no JAX and need no conftest: run them on the card
with ``python3 -m pytest --noconftest -m card
tests/test_torch_pef_kernel.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audioflux_torch.mir.pitch import PitchPEF
from audioflux_torch.ops import _build, cuda_fft, cuda_pef

SR = 32000
PLAN = dict(samplate=SR, low_fre=32.0, high_fre=2000.0, cut_fre=4000.0,
            radix2_exp=12, slide_length=1024)      # the benchmark's plan


def _signal(shape, seed=0, f0=220.0):
    """A tone with an overtone and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SR
    x = (0.4 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(4 * np.pi * f0 * t)
         + 0.01 * rng.standard_normal(shape))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def plan():
    return PitchPEF(device="cpu", **PLAN)


def _log_power_args(p):
    return dict(fft_length=p.fft_length, slide_length=p.slide_length)


# ------------------------------------------------------------ the route

@pytest.mark.parametrize("is_cuda,dtype,n,xn,want", [
    (True, torch.float32, 4096, 32768, True),     # the benchmark's plan
    (True, torch.float32, 2048, 16384, False),
    (True, torch.float32, 4096, 16384, False),    # no pad: another length
    (True, torch.float32, 8192, 65536, False),
    (True, torch.float64, 4096, 32768, False),
    (False, torch.float32, 4096, 32768, False),   # the CPU
])
def test_route_choice(is_cuda, dtype, n, xn, want):
    x = SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    assert cuda_pef.supports(x, n, xn) == want


def test_the_benchmarks_plan_takes_the_kernels(plan):
    """The cell's plan has the lengths the kernels are built for, a grid of
    8192 points at an odd pad, and keeps linear bins 2 .. 1025."""
    assert (plan.fft_length, plan.xcorr_fft_length) == (4096, 32768)
    assert plan._pad_num == 933 and len(plan._log_fre) == 8192
    assert plan._pos_bins == (2, 1025)
    assert (plan.min_index, plan.max_index) == (1590, 7243)
    assert plan._ff_half.shape == (16385, 2)


def test_pitch_routes_a_cpu_call_to_pef_impl(plan, monkeypatch):
    """On the CPU ``PitchPEF.pitch`` runs ``_pef_impl`` and never the
    wrappers; ``_pef_impl`` is the chain of the plan's helpers."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call took a kernel's wrapper")
    monkeypatch.setattr(cuda_pef, "pef_log_power", refuse)
    monkeypatch.setattr(cuda_pef, "pef_xcorr_pitch", refuse)
    x = _signal((2, 12288), seed=1)
    got = plan.pitch(x)
    assert torch.equal(got, plan._pef_impl(torch.from_numpy(x)))
    pr, pi = plan._xcorr_spectrum(plan._log_power(x))
    xc = cuda_fft.fft_inv_ref(pr, pi, n=plan.xcorr_fft_length)[0]
    lag = torch.argmax(xc[..., plan.min_index:plan.max_index + 1], -1)
    assert torch.equal(got, plan._log_fre_t[lag + plan.min_index])
    assert got.shape == (2, 9)


# ---------------------------------------------- the wrappers on the CPU

def test_cpu_policy(plan, monkeypatch):
    """CPU tensors take the plain versions, which are the plan's helpers,
    and never build or count a launch."""
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    x = torch.from_numpy(_signal((3, 10000), seed=2))
    before = (cuda_pef.pef_log_power.launches,
              cuda_pef.pef_xcorr_pitch.launches)
    lp = cuda_pef.pef_log_power(x, plan._window_t, plan._pos_t, plan._w_t,
                                plan._band_width_t, bins=plan._pos_bins,
                                **_log_power_args(plan))
    assert lp.shape == (3, 6, 8192)
    assert torch.equal(lp, plan._log_power(x))
    fre = cuda_pef.pef_xcorr_pitch(lp, plan._ff_half, plan._log_fre_t,
                                   **plan._xcorr_plan())
    assert torch.equal(fre, plan._pef_impl(x))
    assert (cuda_pef.pef_log_power.launches,
            cuda_pef.pef_xcorr_pitch.launches) == before


@pytest.mark.parametrize("change,err", [
    (dict(samples=4000), ValueError),              # no frame
    (dict(slide_length=0), ValueError),
    (dict(bins=(0, 4097)), ValueError),            # past the last bin
    (dict(bins=(5, 5)), ValueError),
    (dict(window=torch.ones(2048)), ValueError),
    (dict(dtype=torch.float64), TypeError),
])
def test_log_power_checks(plan, change, err):
    samples = change.pop("samples", 8192)
    dtype = change.pop("dtype", torch.float32)
    kw = dict(window=plan._window_t, bins=plan._pos_bins,
              **_log_power_args(plan)) | change
    x = torch.zeros(2, samples, dtype=dtype)
    with pytest.raises(err):
        cuda_pef.pef_log_power(x, kw.pop("window"), plan._pos_t, plan._w_t,
                               plan._band_width_t, **kw)


@pytest.mark.parametrize("change,err", [
    (dict(pad_num=32768 - 8191), ValueError),      # the row past the end
    (dict(pad_num=-1), ValueError),
    (dict(min_index=10, max_index=9), ValueError),
    (dict(max_index=8192), ValueError),            # past the grid
    (dict(ff=torch.zeros(16384, 2)), ValueError),
    (dict(dtype=torch.float64), TypeError),
])
def test_xcorr_pitch_checks(plan, change, err):
    dtype = change.pop("dtype", torch.float32)
    kw = dict(plan._xcorr_plan(), ff=plan._ff_half) | change
    lp = torch.zeros(2, 8192, dtype=dtype)
    with pytest.raises(err):
        cuda_pef.pef_xcorr_pitch(lp, kw.pop("ff"), plan._log_fre_t, **kw)


# ------------------------------------------- the front's index model

def _w(k, n):
    return np.exp(-2j * np.pi * k / n)


def _front_model(frame, p):
    """``pef_log_power_kernel`` past its transform on one windowed frame
    (float64): the split of the pairs that hold a kept bin, the power of
    each kept bin written once, the interpolation.  Returns the row."""
    N, T = p.fft_length, 64              # RealRoute<1>: 64 threads a frame
    b0, b1 = p._pos_bins
    x = np.zeros(2 * N)
    x[:N] = frame
    Z = np.fft.fft(x[0::2] + 1j * x[1::2])

    def needed(i):
        lo, hi = T * i, T * i + T - 1
        return ((lo <= b1 and b0 <= hi) or (N - hi <= b1 and b0 <= N - lo)
                or (i == 0 and (b0 <= N // 2 <= b1 or b1 >= N)))

    power = np.full(b1 - b0 + 1, np.nan)

    def put(b, xv):
        if b0 <= b <= b1:
            assert np.isnan(power[b - b0]), f"bin {b} written twice"
            power[b - b0] = xv.real ** 2 + xv.imag ** 2

    for t in range(T):
        for i in range(N // 2 // T):
            if not needed(i):
                continue
            k = t + T * i
            za, zb = Z[k], Z[N // 2 if k == 0 else N - k]
            if k == 0:
                put(0, za.real + za.imag)
                put(N // 2, np.conj(zb))
                put(N, za.real - za.imag)
                continue
            e = (za + np.conj(zb)) / 2
            o = (za - np.conj(zb)) / 2j
            put(k, e + _w(k, 2 * N) * o)
            put(N - k, np.conj(e - _w(k, 2 * N) * o))
    assert not np.isnan(power).any()
    pos = p._pos_t.numpy() - b0
    w = p._w_t.numpy().astype(np.float64)
    bw = p._band_width_t.numpy().astype(np.float64)
    p1, p2 = power[pos], power[pos + 1]
    return (p1 + w * (p2 - p1)) * bw, sum(map(needed, range(N // 2 // T)))


def test_front_index_model(plan):
    """The front's kept bins and interpolation, index for index in
    float64, against the plain version's formula in float64: equal to
    1e-12 of the row's peak; 17 of a thread's 32 pairs hold a bin the grid
    reads."""
    x = _signal((3 * 1024 + 4096,), seed=3).astype(np.float64)
    win = plan._window_t.numpy().astype(np.float64)
    pos = plan._pos_t.numpy()
    w = plan._w_t.numpy().astype(np.float64)
    bw = plan._band_width_t.numpy().astype(np.float64)
    for f in range(4):
        frame = x[1024 * f:1024 * f + 4096] * win
        power = np.abs(np.fft.rfft(frame, n=8192)) ** 2
        p1, p2 = power[pos], power[pos + 1]
        want = (p1 + w * (p2 - p1)) * bw
        got, pairs = _front_model(frame, plan)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    assert pairs == 17


# -------------------------------------------- the back's index model

N_BACK, T_BACK, C_BACK = 16384, 256, 4    # RealRoute<4>
P_BACK = 64 * C_BACK + C_BACK             # a row of the transpose buffer


def _bitrev2(j):
    return ((j & 1) << 1) | (j >> 1)


def _thread_bins(u):
    """Thread u's bins after the forward: k = g + 64 ka + 4096 kb at
    v[ka]."""
    g, kb = u // C_BACK, _bitrev2(u % C_BACK)
    return [g + 64 * ka + 4096 * kb for ka in range(64)]


def _xslot(i):
    """The exchange's float2 slot i in the buffer: rows of 130 float2,
    columns below 128 (``pef.cu`` ``xslot``)."""
    return (i // 128) * (P_BACK // 2) + i % 128


def _partner_slot(u, ka):
    """The slot the thread u reads for its bin at ka < 32 (``pef.cu``)."""
    g = u // C_BACK
    return (31 - ka) * T_BACK + (T_BACK + 3 - u) if g else \
        (32 - ka) * T_BACK + (3 - u)


def test_exchange_layout():
    """The bins of ka >= 32 fill 8192 slots once each, inside the
    transpose buffer's columns the transforms use; the slot each bin of ka
    < 32 reads holds its partner N - k, but for g = 0 at ka = 0, whose
    partners are lanes of its warp; every slot of ka >= 32 is read once
    but for g = 0 at ka = 32, again lanes of one warp (xor 3); a warp's
    writes fall in distinct banks, 16 consecutive slots a half-warp."""
    holder = {}
    for u in range(T_BACK):
        for ka in range(32, 64):
            i = (ka - 32) * T_BACK + u
            assert i not in holder
            holder[i] = _thread_bins(u)[ka]
    assert sorted(holder) == list(range(8192))
    words = [2 * _xslot(i) for i in holder]
    assert all(w % P_BACK < 256 for w in words)
    assert max(words) + 1 < 63 * P_BACK + 256     # kBackBuf
    read = []
    for u in range(T_BACK):
        for ka in range(32):
            k = _thread_bins(u)[ka]
            if u < C_BACK and ka == 0:
                partner = (N_BACK - k) % N_BACK
                lane = u ^ 1 if u >= 2 else u
                assert partner in (0, k) or partner == _thread_bins(lane)[0]
                continue
            i = _partner_slot(u, ka)
            assert holder[i] == (N_BACK - k) % N_BACK
            read.append(i)
    assert len(set(read)) == len(read) == 8192 - C_BACK
    left = set(range(8192)) - set(read)
    assert left == {u for u in range(C_BACK)}          # g = 0 at ka = 32
    for u in range(C_BACK):
        k = _thread_bins(u)[32]
        assert _thread_bins(u ^ 3)[32] == N_BACK - k
    for w in range(T_BACK // 32):
        for ka in range(32, 64):
            for h in range(2):
                us = range(32 * w + 16 * h, 32 * w + 16 * h + 16)
                slots = [_xslot((ka - 32) * T_BACK + u) for u in us]
                assert len({(2 * sl) % 32 for sl in slots}) == 16


def _fslot(k):
    return k ^ ((k >> 12) << 2)


def test_filter_slots_are_conflict_free():
    """The filter's swizzled slots: a bijection, and a half-warp's reads of
    its bins and of their partners fall in 16 distinct float2 banks."""
    assert sorted(map(_fslot, range(N_BACK))) == list(range(N_BACK))
    for h in range(T_BACK // 16):
        us = range(16 * h, 16 * h + 16)
        for ka in range(1, 64):
            ks = [_thread_bins(u)[ka] for u in us]
            for kk in (ks, [(N_BACK - k) % N_BACK for k in ks]):
                assert len({_fslot(k) % 16 for k in kk}) == 16 or h == 0


def _merge(za, zb, w, fa, fb):
    """``pef.cu`` ``pair_merge`` in float64: the packed inverse's points k
    and N - k from Z[k], Z[N - k]."""
    e, o = (za + np.conj(zb)) / 2, (za - np.conj(zb)) / 2j
    pa = (e + w * o) * fa
    pb = np.conj(e - w * o) * fb
    own = np.conj(pa + np.conj(pb) + 1j * (pa - np.conj(pb)) * np.conj(w))
    other = np.conj(pb + np.conj(pa) + 1j * (pb - np.conj(pa)) * -w)
    return own, other


def _back_model(row, p):
    """``pef_xcorr_pitch_kernel`` past its forward on one log-grid row
    (float64), step by step: the bins of ka >= 32 into their slots, each
    bin of ka < 32 merged with its partner's from its slot and the
    partner's merged point written back there, the lanes' own pairs, the
    merged points of ka >= 32 read back; the inverse's transform; the lags
    the thread of point m holds.  Returns the cross-correlation at every
    lag."""
    X, N = p.xcorr_fft_length, N_BACK
    buf = np.zeros(X)
    buf[p._pad_num:p._pad_num + len(row)] = row
    Z = np.fft.fft(buf[0::2] + 1j * buf[1::2])
    ff = p._ff_half.numpy().astype(np.float64)
    cf = ff[:, 0] + 1j * ff[:, 1]           # conj(Ff), bins 0 .. N
    fa_of = lambda k: cf[k]                   # noqa: E731
    vs = [[Z[k] for k in _thread_bins(u)] for u in range(T_BACK)]
    slots = {}
    for u in range(T_BACK):
        for ka in range(32, 64):
            slots[(ka - 32) * T_BACK + u] = vs[u][ka]
    z0 = [vs[u ^ 1][0] for u in range(T_BACK)]
    z32 = [vs[u ^ 3][32] for u in range(T_BACK)]
    for u in range(T_BACK):
        g = u // C_BACK
        for ka in range(32):
            k = _thread_bins(u)[ka]
            w = _w(k, X)
            if g == 0 and ka == 0:
                za = vs[u][0]
                if u == 0:
                    p0 = (za.real + za.imag) * cf[0].real
                    pn = (za.real - za.imag) * cf[N].real
                    vs[u][0] = complex(p0 + pn, pn - p0)
                else:
                    zb = za if u == 1 else z0[u]
                    vs[u][0] = _merge(za, zb, w, cf[k], cf[N - k])[0]
                continue
            i = _partner_slot(u, ka)
            vs[u][ka], slots[i] = _merge(vs[u][ka], slots[i], w, fa_of(k),
                                         cf[N - k])
    for u in range(T_BACK):
        for ka in range(32, 64):
            k = _thread_bins(u)[ka]
            if u < C_BACK and ka == 32:
                vs[u][ka] = _merge(vs[u][ka], z32[u], _w(k, X), cf[k],
                                   cf[N - k])[0]
            else:
                vs[u][ka] = slots[(ka - 32) * T_BACK + u]
    v = np.empty(N, dtype=complex)
    for u in range(T_BACK):
        v[_thread_bins(u)] = vs[u]
    F = np.fft.fft(v)                          # route_transform_back
    xc = np.empty(X)
    xc[0::2] = F.real / X
    xc[1::2] = -F.imag / X
    return xc


def test_back_index_model(plan):
    """The back's pairing with conj(Ff) and the half spectrum's merge,
    index for index in float64, give the plain version's cross-correlation
    in float64 at every lag, to 1e-12 of the peak."""
    x = torch.from_numpy(_signal((4096 + 1024,), seed=4).astype(np.float64))
    lp = cuda_pef.pef_log_power_ref(
        x, plan._window_t.double(), plan._pos_t, plan._w_t.double(),
        plan._band_width_t.double(), **_log_power_args(plan))
    X, pad = plan.xcorr_fft_length, plan._pad_num
    ff = plan._ff_half.double()
    for r in range(lp.shape[0]):
        row = lp[r].numpy()
        got = _back_model(row, plan)
        buf = np.zeros(X)
        buf[pad:pad + len(row)] = row
        spec = np.fft.rfft(buf) * (ff[:, 0].numpy() + 1j * ff[:, 1].numpy())
        want = np.fft.irfft(spec, n=X)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def _beats(a, la, b, lb):
    """``pef.cu`` ``beats``: the larger value, a NaN above all, the lower
    lag among equals; a negative lag is no candidate."""
    if la < 0:
        return False
    if lb < 0:
        return True
    if a != a:
        return b == b or la < lb
    if b != b:
        return False
    return a > b or (a == b and la < lb)


def _pick_model(xc, lo, hi):
    """The arg-max as the block runs it: the even lags 2 m in [lo, hi],
    then the odd ones 2 m + 1, thread t over m = m_lo + t, m_lo + t + 256,
    ... (the larger value, a NaN over any number, the lower lag among
    equals), each warp's xor shuffles, then warp 0's over the warps'
    winners."""
    best = []
    for t in range(T_BACK):
        b, lag = 0.0, -1
        for c in (0, 1):
            for m in range((lo - c + 1) // 2 + t, (hi - c) // 2 + 1, T_BACK):
                if _beats(xc[2 * m + c], 2 * m + c, b, lag):
                    b, lag = xc[2 * m + c], 2 * m + c
        best.append((b, lag))

    def meet(vals):
        for h in (16, 8, 4, 2, 1):
            vals = [vals[t ^ h] if _beats(*vals[t ^ h], *vals[t]) else vals[t]
                    for t in range(32)]
        return vals

    winners = []
    for w in range(T_BACK // 32):
        winners.append(meet(best[32 * w:32 * w + 32])[0])
    last = meet([winners[t] if t < len(winners) else (0.0, -1)
                 for t in range(32)])
    return last[0][1]


def _planted(lo, hi, lags, value=5.0, seed=0, nan=()):
    rng = np.random.default_rng(seed)
    xc = rng.uniform(-1.0, 1.0, 32768)
    for l in lags:
        xc[l] = value
    for l in nan:
        xc[l] = np.nan
    return xc


PICKS = {
    # name: (planted maxima, NaNs)
    "one maximum": ([4001], ()),
    "tie in one thread, odd before even": ([2 * (795 + 7 + 256 * 9),
                                            2 * (795 + 7 + 256 * 5) + 1], ()),
    "tie across lanes of a warp": ([2 * (795 + 9 + 256 * 6),
                                    2 * (795 + 3 + 256 * 7) + 1], ()),
    "tie across warps, the later warp lower": ([2 * (795 + 200 + 256 * 4),
                                                2 * (795 + 40 + 256 * 5)],
                                               ()),
    "tie at the range's ends": ([1590, 7243], ()),
    "maxima outside the range": ([1589, 7244, 3000], ()),
    "a NaN": ([5000], [6001]),
    "two NaNs": ([], [6001, 4000]),
}


@pytest.mark.parametrize("name", sorted(PICKS))
def test_first_max_rule(name, plan):
    """The block's arg-max keeps the lag ``torch.argmax`` keeps over
    [min_index, max_index]: the first of equal maxima, wherever the
    threads and warps that hold them lie, and the first NaN."""
    lo, hi = plan.min_index, plan.max_index
    lags, nan = PICKS[name]
    xc = _planted(lo, hi, lags, nan=nan, seed=len(name))
    want = torch.argmax(torch.from_numpy(xc[lo:hi + 1])).item() + lo
    assert _pick_model(xc, lo, hi) == want


def test_first_max_rule_on_a_real_row(plan):
    """The arg-max of a row's cross-correlation, and of the same row with
    its maximum copied to a later lag of another warp."""
    x = torch.from_numpy(_signal((4096,), seed=5).astype(np.float64))
    lp = cuda_pef.pef_log_power_ref(
        x, plan._window_t.double(), plan._pos_t, plan._w_t.double(),
        plan._band_width_t.double(), **_log_power_args(plan))
    xc = _back_model(lp[0].numpy(), plan)
    lo, hi = plan.min_index, plan.max_index
    first = int(np.argmax(xc[lo:hi + 1])) + lo
    assert _pick_model(xc, lo, hi) == first
    xc[hi - 3] = xc[first]
    assert _pick_model(xc, lo, hi) == first


# ----------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda:0")


# at most this share of frames may pick another lag, a neighbour whose
# value lies within NEAR_TIE of the peak in float64: the peak of the
# cross-correlation is flat on the fine log grid, and in the plain path's
# float32 the two lags' values are often equal (0.08% of the benchmark's
# frames, PERF.md)
SHARE = 2e-3
NEAR_TIE = 1e-6


def _xcorr64(p, lp):
    """The cross-correlation of log-grid rows in float64 (the filter's
    spectrum too), on the CPU."""
    X = p.xcorr_fft_length
    rows = lp.double().cpu()
    buf = torch.nn.functional.pad(rows, (p._pad_num,
                                         X - p._pad_num - rows.shape[-1]))
    h = torch.from_numpy(p._filter.astype(np.float64))
    Ff = torch.fft.rfft(torch.nn.functional.pad(h, (0, X - len(h))))
    return torch.fft.irfft(torch.fft.rfft(buf) * Ff.conj(), n=X)


def _hold_pitch(label, p, x, got):
    """The kernels' pitch against ``_pef_impl`` on the card: equal on all
    but SHARE of the frames, and each other frame a near tie of two
    neighbouring lags in float64."""
    want = p._pef_impl(x)
    diff = (got != want).reshape(-1)
    frames = diff.numel()
    lf = p._log_fre_t
    lines = []
    if diff.any():
        lp = p._log_power(x).reshape(-1, 8192)[diff]
        xc = _xcorr64(p, lp)
        for r, (g, w) in enumerate(zip(got.reshape(-1)[diff].tolist(),
                                       want.reshape(-1)[diff].tolist())):
            lg = int(torch.nonzero(lf == g)[0])
            lw = int(torch.nonzero(lf == w)[0])
            band = xc[r, p.min_index:p.max_index + 1]
            best = int(torch.argmax(band)) + p.min_index
            top = band.abs().max().item()
            gap = abs(xc[r, lg].item() - xc[r, lw].item()) / top
            lines.append((lg, lw, best, gap))
    print(f"{label}: {int(diff.sum())} of {frames} frames differ; (kernel "
          f"lag, plain lag, float64 lag, float64 gap / peak): {lines}")
    assert all(gap <= NEAR_TIE and abs(lg - lw) == 1
               for lg, lw, _, gap in lines), label
    assert diff.float().mean().item() <= SHARE, label


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 60 * SR), (3, 100001)])
def test_kernels_match_the_plain_path_on_the_card(card, shape):
    """The cell's plan on a minute of the benchmark's traffic and on an
    odd length: the front against its plain version (within float32
    rounding of each row's peak), the pitch against ``_pef_impl``."""
    from benchmark import traffic
    x = traffic.mir(shape, traffic.generator(3400002501 + shape[0], card),
                    card, SR)
    p = PitchPEF(device=card, **PLAN)
    lp = cuda_pef.pef_log_power(x, p._window_t, p._pos_t, p._w_t,
                                p._band_width_t, bins=p._pos_bins,
                                **_log_power_args(p))
    ref = p._log_power(x)
    err = ((lp - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
    same = (lp == ref).float().mean().item()
    print(f"front {shape}: {err:.3e} of a row's peak, {same:.4f} equal")
    assert err <= 1e-6
    _hold_pitch(f"pitch {shape}", p, x, p.pitch(x))
    assert torch.equal(p.pitch(x), p.pitch(x))


@pytest.mark.card
def test_one_call_launches_the_two_kernels(card):
    """One ``PitchPEF.pitch`` at the cell's plan launches each kernel once
    and no FFT kernel."""
    x = torch.from_numpy(_signal((2, 30 * SR), seed=6)).to(card)
    p = PitchPEF(device=card, **PLAN)
    counters = (cuda_pef.pef_log_power, cuda_pef.pef_xcorr_pitch,
                cuda_fft.fft_fwd, cuda_fft.fft_inv)
    before = [c.launches for c in counters]
    fre = p.pitch(x)
    torch.cuda.synchronize(card)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    assert fre.shape == (2, (30 * SR - 4096) // 1024 + 1)
