"""The unwrap kernel's run-per-thread plan (``csrc/unwrap_diff.cu``
``unwrap_rows_kernel``) as a model in numpy, and Synsq's one-pass entry
``synsq_bins`` on the CPU.

The CUDA kernel cannot run without the card, so its decomposition — runs
of 16 samples a thread, a block scan a tile of 8192, the count carried
across tiles, the sample before a run from the neighbouring lane or a
load, the scalar path of the rows no multiple of 4 long, Synsq's last
column where it starts a run, and the swizzled staging of a warp's runs —
is mirrored here with the kernel's own fp32 operations and index formulas
and held bit for bit against the plain versions.
``synsq_bins_ref`` is held cell for cell against the PyTorch chain that
Synsq ran before it (``_synsq_map``, the threshold and the drop code).
"""

import numpy as np
import pytest
import torch

import audioflux_torch as aft
from audioflux_torch.ops import _build
from audioflux_torch.ops.cuda_unwrap import (bin_map, synsq_bins,
                                             synsq_bins_ref, unwrap_diff_ref)
from audioflux_torch.transforms import synsq as ts
from audioflux_tpu.types import SpectralFilterBankScaleType as S

THREADS, RUN = 512, 16              # csrc/unwrap_diff.cu kThreads, kRun
TILE = THREADS * RUN
TWO_PI, PI = np.float32(2 * np.pi), np.float32(np.pi)


def _phases(kind, rows, T, seed=0):
    """The kinds of wrapped phase that chip_smoke.py feeds the kernel."""
    rng = np.random.default_rng(seed)
    if kind == "wrapping":      # large steps both ways, far past 2 pi
        t = np.cumsum(rng.uniform(-2.5, 3.0, (rows, T)), axis=-1)
    elif kind == "drifting":    # a slow one-way drift with jitter
        t = np.cumsum(0.3 + 0.05 * rng.uniform(size=(rows, T)), axis=-1)
    else:                       # steady near-pi increments: the knife edge
        t = np.outer(np.ones(rows) * 3.1, np.arange(T))
    return np.float32(np.arctan2(np.sin(t), np.cos(t)))


def _wrap_count(xc, xp):
    """wrap_count of the kernel, in float32, operation for operation."""
    sub = np.abs(np.float32(xc - xp))
    t = np.floor(np.float32(sub / TWO_PI))
    mod = np.float32(sub - np.float32(t * TWO_PI))
    ti = t.astype(np.int64) + (mod > PI)
    k = np.where(xc > xp, -ti, ti)
    return np.where(sub < PI, 0, k)


def _unwrapped(x, c):
    return np.float32(x + np.float32(np.float32(c) * TWO_PI))


def _run_model(x, edge=False):
    """``unwrap_rows_kernel`` over rows x (rows, T): returns e, and with
    ``edge`` also the value each thread takes for the last column (e[T-2]
    where T-1 starts a run, recomputed from cells T-2 and T-3)."""
    rows, T = x.shape
    e = np.full((rows, T), np.nan, np.float32)
    last = np.full(rows, np.nan, np.float32)
    scalar_runs = 0
    for r in range(rows):
        carry = 0
        for base in range(0, T, TILE):
            j0 = base + RUN * np.arange(THREADS)
            j = j0[:, None] + np.arange(RUN)[None, :]          # (threads, run)
            live = j < T
            xv = np.where(live, x[r, np.minimum(j, T - 1)], 0).astype(
                np.float32)
            # a warp's span goes in and out as 16-byte words when whole and
            # aligned (the row starts at r * T floats), else one sample at
            # a time
            wj0 = j0 - RUN * (np.arange(THREADS) % 32)
            staged = (wj0 + 32 * RUN <= T) & ((r * T + wj0) % 4 == 0)
            scalar_runs += int((~staged & (j0 < T)).sum())
            # the sample before the run: lane - 1's last, or a load at
            # the warp's edge (lane 0)
            xp = np.roll(xv[:, -1], 1)
            lane0 = np.arange(THREADS) % 32 == 0
            load = lane0 & (j0 > 0) & (j0 <= T)
            xp[load] = x[r, j0[load] - 1]
            prev = np.concatenate([xp[:, None], xv[:, :-1]], axis=1)
            k = np.where((j > 0) & live, _wrap_count(xv, prev), 0)
            totals = k.sum(axis=1)
            # the block's scan and the carry
            before = carry + np.concatenate([[0], np.cumsum(totals)[:-1]])
            carry += int(totals.sum())
            c = before[:, None] + np.cumsum(k, axis=1)
            y = _unwrapped(xv, c)
            yp = np.concatenate([_unwrapped(xp, before)[:, None], y[:, :-1]],
                                axis=1)
            ev = np.where(j > 0, np.float32(y - yp), np.float32(0))
            e[r, j[live]] = ev[live]
            if edge and T >= 2:
                t_last = (T - 1 - base) // RUN
                if 0 <= t_last < THREADS and (T - 1) % RUN == 0:
                    if T - 1 == 0:
                        last[r] = 0.0
                    else:
                        xpp = x[r, T - 3]
                        kp = _wrap_count(xp[t_last], xpp)
                        last[r] = np.float32(
                            _unwrapped(xp[t_last], before[t_last])
                            - _unwrapped(xpp, before[t_last] - kp))
                elif 0 <= t_last < THREADS:
                    last[r] = ev[t_last, (T - 1) % RUN - 1]
    assert not np.isnan(e).any()
    return (e, last, scalar_runs) if edge else (e, scalar_runs)


@pytest.mark.parametrize("T", [1, 3, 17, 8191, 8193, 32768])
@pytest.mark.parametrize("kind", ["wrapping", "drifting", "steady"])
def test_unwrap_run_model_bit_equal(T, kind):
    rows = 3 if T <= 8193 else 1
    x = _phases(kind, rows, T, seed=T)
    got, scalar_runs = _run_model(x)
    want = unwrap_diff_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    # a row's ragged end, and rows at unaligned addresses, take the scalar
    # path
    assert (scalar_runs > 0) == (T % (32 * RUN) != 0)


@pytest.mark.parametrize("T", [2, 17, 33, 8193, 16385])
def test_synsq_last_column_model(T):
    """The last column repeats e[T-2]; where it starts a run (T - 1 a
    multiple of 16) the thread recomputes e[T-2] from two more cells.
    Bit-equal to the plain version's phase rate before the bin map."""
    x = _phases("wrapping", 2, T, seed=T)
    e, last, _ = _run_model(x, edge=True)
    want = unwrap_diff_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(e, want)
    assert np.array_equal(last, want[:, T - 2])


def _swz(V, t, s):
    """csrc/unwrap_diff.cu swz<V>: word s of thread t's run, XOR-swizzled."""
    return t * V + (s ^ ((t // (8 // V)) & (V - 1)))


@pytest.mark.parametrize("V", [4, 8])
def test_staging_swizzle_is_conflict_free(V):
    """A warp's runs of V 16-byte words in the staging buffer: every word
    has one place, a thread's reads (word q of every lane) and the warp's
    copies (word lane + 32 q of the span) each touch 8 distinct bank quads
    per quarter warp, so neither side conflicts in the banks."""
    places = [_swz(V, t, s) for t in range(32) for s in range(V)]
    assert sorted(places) == list(range(32 * V))
    for q in range(V):
        reads = [_swz(V, t, q) for t in range(32)]
        copies = [_swz(V, i // V, i % V)
                  for i in (lane + 32 * q for lane in range(32))]
        for addr in (reads, copies):
            for quarter in range(4):
                quads = {a % 8 for a in addr[8 * quarter:8 * quarter + 8]}
                assert len(quads) == 8


def _upper_bound(f, v):
    """The kernel's binary search, searchsorted(f, v, right=True)."""
    lo, hi = 0, len(f)
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if not f[mid] > v:
            lo = mid + 1
        else:
            hi = mid
    return lo


def test_binary_search_matches_searchsorted():
    rng = np.random.default_rng(1)
    f = np.sort(rng.uniform(0, 0.5, 84)).astype(np.float32)
    f[10] = f[11]                                    # a tie
    v = np.concatenate([rng.uniform(-0.1, 0.6, 500), f, [np.inf, -np.inf]]
                       ).astype(np.float32)
    want = torch.searchsorted(torch.from_numpy(f), torch.from_numpy(v),
                              right=True).numpy()
    assert [_upper_bound(f, a) for a in v] == want.tolist()


def _cells(B, num, T, seed):
    """(B, num, T) complex64 cells whose band rows take the three kinds of
    phase in turn (atan2(re, im) gives the phase back), magnitudes over
    1e-4.5 .. 1 around the threshold, every 37th cell exactly 0."""
    rng = np.random.default_rng(seed)
    kinds = [_phases(k, B * num, T, seed)
             for k in ("wrapping", "drifting", "steady")]
    ph = np.stack(kinds)[np.arange(B * num) % 3, np.arange(B * num)]
    mag = (10 ** rng.uniform(-4.5, 0, (B * num, T))).astype(np.float32)
    mag.reshape(-1)[::37] = 0
    D = (mag * np.sin(ph) + 1j * mag * np.cos(ph)).astype(np.complex64)
    return torch.from_numpy(D.reshape(B, num, T))


# band frequencies of each scale kind (48 bands; octave bands 6 a octave)
_LAYOUTS = {"log": 32.703 * 2 ** (np.arange(48) / 6),
            "linear": np.linspace(100.0, 8000.0, 48),
            "nearest": np.sort(np.random.default_rng(5).uniform(20, 15000,
                                                                48))}


@pytest.mark.parametrize("kind", ["log", "linear", "nearest"])
@pytest.mark.parametrize("order", [1, 2])
def test_synsq_bins_ref_equals_the_chain(kind, order):
    """Cell for cell: order 1 with the threshold's drop code, and the
    order-2 composition of the map without it."""
    num, T = 48, 300
    D = _cells(2, num, T, seed=order)
    fre = torch.from_numpy(_LAYOUTS[kind].astype(np.float32))
    chain = ts._synsq_map(D, fre, scale_kind=kind, num=num, samplate=32000.0)
    if order == 1:
        power = D.real ** 2 + D.imag ** 2
        th = torch.tensor(np.float32(0.001))
        ok = (chain >= 0) & (chain < num) & (power > th * th)
        want = torch.where(ok, chain, torch.full_like(chain, num))
        got = synsq_bins_ref(D, fre, kind, num, 32000.0, 0.001)
        assert 0 < int((got == num).sum()) < got.numel()
    else:
        want = ts._compose_order(chain, num, 2)
        got = ts._compose_order(synsq_bins_ref(D, fre, kind, num, 32000.0),
                                num, 2)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert float(((got >= 0) & (got < num)).float().mean()) > 0.05


@pytest.mark.parametrize("T", [1, 2, 3])
def test_synsq_bins_short_rows(T):
    """One column keeps its phase rate 0; two columns both take e[0] = 0
    (the last column copies the one before it)."""
    D = _cells(1, 4, T, seed=T)
    fre = torch.tensor([100.0, 200.0, 400.0, 800.0])
    got = synsq_bins_ref(D, fre, "linear", 4, 32000.0)
    assert got.shape == D.shape and got.dtype == torch.int32
    if T <= 2:
        zero = bin_map(torch.zeros(1), fre, scale_kind="linear", num=4,
                       samplate=32000.0)
        assert (got == zero).all()


@pytest.mark.parametrize("order", [1, 2])
def test_synsq_goldens_take_the_one_pass_entry(goldens, monkeypatch, order):
    """Synsq.synsq runs the golden input through synsq_bins (on the CPU
    its plain version): with the threshold for order 1, without it for
    order 2; ``force_xla_unwrap`` takes the PyTorch chain and agrees."""
    g = goldens("synsq")
    C = (g["in_re"] + 1j * g["in_im"]).astype(np.complex64)
    calls = []

    def spy(*args):
        calls.append(args[5:])
        return synsq_bins(*args)
    monkeypatch.setattr(ts, "synsq_bins", spy)
    plan = aft.Synsq(num=84, radix2_exp=12, samplate=32000, order=order,
                     device="cpu")
    R = plan.synsq(C, S.OCTAVE, g["in_fre"])
    assert calls == [((0.001,) if order == 1 else ())]
    pinned = plan.synsq(C, S.OCTAVE, g["in_fre"], force_xla_unwrap=True)
    assert len(calls) == 1
    assert torch.equal(torch.view_as_real(R), torch.view_as_real(pinned))
    if order == 1:
        ref = g["synsq_re"] + 1j * g["synsq_im"]
        match = np.abs(R.numpy() - ref) <= 1e-4 * np.abs(ref).max()
        assert match.mean() >= 0.995


def test_synsq_bins_cpu_policy_and_checks(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    D = _cells(1, 8, 64, seed=3)
    fre = torch.linspace(100.0, 4000.0, 8)
    before = synsq_bins.launches
    got = synsq_bins(D, fre, "nearest", 8, 32000.0, 0.001)
    assert torch.equal(got, synsq_bins_ref(D, fre, "nearest", 8, 32000.0,
                                           0.001))
    assert synsq_bins.launches == before
    with pytest.raises(TypeError):
        synsq_bins(D.to(torch.complex128), fre, "log", 8, 32000.0)
    for args in ((D, fre, "mel", 8, 32000.0), (D, fre, "log", 9, 32000.0),
                 (D, fre, "log", 0, 32000.0), (D[..., :0], fre, "log", 8,
                                               32000.0)):
        with pytest.raises(ValueError):
            synsq_bins(*args)
