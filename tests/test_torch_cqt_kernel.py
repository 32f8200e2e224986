"""The CQT's octaves in one kernel (``ops.cuda_cqt``, ``csrc/cqt.cu``):
which calls take it, the plan's run table, the wrapper's checks and its
CPU policy, and the kernel's indices as a float64 model held against the
plain path; on the card (marker ``card``), the kernel against the plain
path.

The kernel cannot run without the card, so what can go wrong before any
rounding does — which span of which level a block reads, where the
padding and the cut fall, each frame's points in the 16 x 16 transform
(the column DFT, the twiddle table, the exchange, the row DFT), the
partner that the split takes by shuffle, the columns the group skips,
the kept bins' slots, each row's run and the transposed store — is
mirrored here with the kernel's own index formulas in float64 and held
against a float64 CQT of the same levels.

The card tests import no JAX and need no conftest: run them on the card
with ``python3 -m pytest --noconftest -m card
tests/test_torch_cqt_kernel.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import audioflux_torch as aft
from audioflux_torch.ops import _build, cuda_cqt

SR = 32000
CELL = dict(num=84, samplate=SR)          # the benchmark's plan
SPAN_MAX = 12288                          # cqt.cu kSpanMax
SMEM_MAX = 232448                         # cqt.cu kSmemMax


def _signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SR
    x = (0.3 * np.sin(2 * np.pi * 261.6 * t)
         + 0.2 * np.sin(2 * np.pi * 3100 * t)
         + 0.05 * rng.standard_normal(shape))
    return x.astype(np.float32)


def _levels(plan, x):
    """The plan's resample chain, lowest octave first."""
    levels = [x]
    for _ in range(plan.octave_num - 1):
        levels.append(plan._resampler.resample(levels[-1]))
    return levels[::-1]


@pytest.fixture(scope="module")
def cell():
    return aft.CQT(device="cpu", **CELL)


# ------------------------------------------------------------ the route

CELL_SLIDES = [2, 4, 8, 16, 32, 64, 128]


@pytest.mark.parametrize("is_cuda,dtype,n,slides,T,want", [
    (True, torch.float32, 512, CELL_SLIDES, 7501, True),          # the cell
    (True, torch.float32, 1024, [4, 8, 16, 32, 64, 128, 256], 7501, False),
    (True, torch.float64, 512, CELL_SLIDES, 7501, False),
    (False, torch.float32, 512, CELL_SLIDES, 7501, False),        # CPU
    (True, torch.float32, 512, [0, 1, 2, 4, 8, 16, 32], 99, False),  # slide 0
    (True, torch.float32, 512, [1] * 17, 99, False),              # 17 octaves
    (True, torch.float32, 512, [101], 100, True),
    # a block's span: 63 x 186 + 512 = 12230 fits, 63 x 187 + 512 not
    (True, torch.float32, 512, [186], 7501, True),
    (True, torch.float32, 512, [187], 7501, False),
    # slide 1024: 5 frames (4,096-sample clips) fit, 13 frames not
    (True, torch.float32, 512, [16, 32, 64, 128, 256, 512, 1024], 5, True),
    (True, torch.float32, 512, [16, 32, 64, 128, 256, 512, 1024], 13, False),
])
def test_route_choice(is_cuda, dtype, n, slides, T, want):
    x = SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    assert cuda_cqt.supports(x, n, slides, T) == want


@pytest.mark.parametrize("make,n", [
    (lambda: aft.CQT(device="cpu", **CELL), 512),
    (lambda: aft.SimpleCQT(device="cpu"), 512),
    (lambda: aft.VQT(device="cpu"), 512),
    (lambda: aft.CQT(num=168, bin_per_octave=24, device="cpu"), 1024),
    (lambda: aft.CQT(num=252, bin_per_octave=36, device="cpu"), 1024),
])
def test_which_plans_have_the_kernels_length(make, n):
    assert make().fft_length == n


def test_the_cells_plan_takes_the_kernel(cell):
    """fft_length 512, slides 128 down to 2, and one kernel of 131
    nonzeros in each octave's table: every row one run from its first
    nonzero to its last (136 values, 5 of them zeros inside a run), bins
    29 to 70 kept; the dense planes uploaded once for the seven octaves."""
    assert cell.fft_length == 512 and cell.octave_num == 7
    assert cell._octave_slides() == CELL_SLIDES
    assert cuda_cqt.span(CELL_SLIDES, 7501) == 8576 <= SPAN_MAX
    kern = cell._kernels_t
    assert (kern.lo, kern.hi) == (29, 71)
    meta = kern.meta.numpy()
    vals = kern.vals.numpy()
    k = cell._kernels[0]
    assert all(p is kern.planes[0] for p in kern.planes)
    kr, ki = kern.planes[0]
    assert np.array_equal(kr.numpy() + 1j * ki.numpy(), k)
    for o in range(7):
        got = np.zeros_like(k)
        for r, (a, n, off) in enumerate(meta[o]):
            nz = np.flatnonzero(k[r])
            assert (a, a + n - 1) == (nz[0], nz[-1])
            got[r, a:a + n] = vals[off:off + n, 0] + 1j * vals[off:off + n, 1]
        assert np.array_equal(got, k)
        assert int(meta[o, :, 1].sum()) == 136
        assert int(np.count_nonzero(got)) == 131
    assert vals.shape == (7 * 136, 2)


def _vqt_band_width(device):
    """A VQT whose octaves' kernels differ (BAND_WIDTH reads each octave's
    own neighbour frequencies)."""
    return aft.VQT(normal_type=aft.SpectralFilterBankNormalType.BAND_WIDTH,
                   device=device)


def test_vqt_has_a_table_an_octave():
    v = _vqt_band_width("cpu")
    meta, vals = v._kernels_t.meta.numpy(), v._kernels_t.vals.numpy()
    for o in range(v.octave_num):
        k = v._kernels[o]
        for r, (a, n, off) in enumerate(meta[o]):
            got = vals[off:off + n, 0] + 1j * vals[off:off + n, 1]
            assert np.array_equal(got, k[r, a:a + n])
    assert not np.array_equal(v._kernels[0], v._kernels[6])


def test_a_cpu_call_runs_the_plain_path(cell, monkeypatch):
    """On the CPU ``cqt`` and ``_cqt_frames`` run the plain version on the
    resample chain's levels and never the wrapper; a frame range is the
    whole call's frames, zero past the last."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call took the kernel's wrapper")
    plain = cuda_cqt.cqt_octaves_ref
    calls = []

    def counted(levels, slides, *a, **k):
        levels = list(levels)
        calls.append((tuple(lv.shape[-1] for lv in levels), tuple(slides),
                      k["T"], k["t0"], k["center"]))
        return plain(iter(levels), slides, *a, **k)
    monkeypatch.setattr(cuda_cqt, "cqt_octaves", refuse)
    monkeypatch.setattr(cuda_cqt, "cqt_octaves_ref", counted)
    x = torch.from_numpy(_signal((2, 20000), seed=1))
    got = cell.cqt(x)
    assert got.shape == (2, 84, 157) and got.dtype == torch.complex64
    part = cell._cqt_frames(x, 140, 180)
    assert torch.equal(part[..., :17], got[..., 140:])
    assert not part[..., 17:].any()
    lens = (20000, 10000, 5000, 2500, 1250, 625, 312)     # top octave first
    slides = tuple(CELL_SLIDES)
    assert calls == [(lens, slides, 157, 0, True),
                     (lens, slides, 40, 140, True)]


def test_the_plain_route_makes_each_level_after_the_octave_above(
        monkeypatch):
    """The plain route frames an octave before the chain makes the next
    level (one level and one octave's spectra alive at a time, as before
    the kernel), top octave first."""
    plan = aft.CQT(device="cpu", **CELL)
    events = []
    resample, octave = plan._resampler.resample, cuda_cqt._octave_ref

    def logged_resample(x):
        events.append(("resample", x.shape[-1]))
        return resample(x)

    def logged_octave(x, slide, *a):
        events.append(("octave", slide))
        return octave(x, slide, *a)
    monkeypatch.setattr(plan._resampler, "resample", logged_resample)
    monkeypatch.setattr(cuda_cqt, "_octave_ref", logged_octave)
    plan.cqt(torch.from_numpy(_signal((1, 8000), seed=4)))
    want = []
    for o, s in enumerate(CELL_SLIDES[::-1]):
        want += [("resample", 8000 >> (o - 1))] if o else []
        want.append(("octave", s))
    assert events == want


def test_no_frames(cell):
    """A frame range of none gives (..., num, 0), as an empty call does."""
    x = torch.from_numpy(_signal((2, 9000), seed=3))
    assert cell._cqt_frames(x, 30, 30).shape == (2, 84, 0)
    got = cuda_cqt.cqt_octaves(_levels(cell, x), cell._octave_slides(),
                               cell._kernels_t, cell._scale_t, fft_length=512,
                               T=0)
    assert got.shape == (2, 84, 0) and got.dtype == torch.complex64


def test_cpu_policy(cell, monkeypatch):
    """A CPU tensor takes the plain version and never builds or counts a
    launch."""
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    x = torch.from_numpy(_signal((3, 9000), seed=2))
    levels = _levels(cell, x)
    before = cuda_cqt.cqt_octaves.launches
    got = cuda_cqt.cqt_octaves(levels, cell._octave_slides(), cell._kernels_t,
                               cell._scale_t, fft_length=512, T=71)
    assert torch.equal(got, cell.cqt(x))
    assert cuda_cqt.cqt_octaves.launches == before


@pytest.mark.parametrize("change,err", [
    (dict(levels=6), ValueError),              # an octave short
    (dict(slides=[0, 4, 8, 16, 32, 64, 128]), ValueError),
    (dict(T=-1), ValueError),
    (dict(t0=-1), ValueError),
    (dict(scale=torch.ones(83)), ValueError),
    (dict(dtype=torch.float64), TypeError),
    (dict(batch=True), ValueError),            # levels of two batch shapes
])
def test_wrapper_checks(cell, change, err):
    change = dict(change)
    dtype = change.pop("dtype", torch.float32)
    levels = [lv.to(dtype) for lv in _levels(cell, torch.zeros(2, 4096))]
    if change.pop("batch", False):
        levels[0] = levels[0][:1]
    levels = levels[:change.pop("levels", 7)]
    kw = dict(slides=cell._octave_slides(), scale=cell._scale_t, T=33,
              t0=0) | change
    with pytest.raises(err):
        cuda_cqt.cqt_octaves(levels, kw["slides"], cell._kernels_t,
                             kw["scale"], fft_length=512, T=kw["T"],
                             t0=kw["t0"])


# ------------------------------------------------ the kernel's index model

def _model(levels, slides, runs, scale, *, T, t0=0, left=256):
    """``cqt_octaves_kernel`` in float64 with its own indices: per block
    (octave, clip, tile of 64 frames) the staged span, the points
    of each frame as the threads load them, the 16-point DFTs with the
    table's twiddle and the exchange, the split with the shuffled partner
    over the kept columns, the kept bins' slots, the runs and the store."""
    meta = runs.meta.numpy()
    vals = runs.vals.numpy().astype(np.float64)
    vals = vals[:, 0] + 1j * vals[:, 1]
    lo, hi = runs.lo, runs.hi
    octaves, bpo = meta.shape[:2]
    sc = scale.numpy().astype(np.float64)
    tw = np.exp(-2j * np.pi * np.arange(512) / 512)
    tbl = np.array([tw[2 * (i >> 4) * (i & 15)] for i in range(256)])
    tile = cuda_cqt.TILE
    assert cuda_cqt.span(slides, T) <= SPAN_MAX
    xs_stride = (hi - lo) | 1
    batch = levels[0].reshape(-1, levels[0].shape[-1]).shape[0]
    out = np.zeros((batch, octaves * bpo, T), np.complex128)
    W16 = np.exp(-2j * np.pi * np.outer(np.arange(16), np.arange(16)) / 16)
    t_ = np.arange(16)[:, None]
    k2_ = np.arange(16)[None, :]
    src = (16 - t_) & 15
    kk = t_ + 16 * k2_                     # the bin thread t holds at k2
    col_kept = ~((16 * k2_ + 16 <= lo) | (16 * k2_ >= hi))
    for o in range(octaves):
        x = levels[o].reshape(batch, -1).double().numpy()
        s, n = slides[o], x.shape[-1]
        cut, frames = n // s * s, n // s + 1
        for ti in range(-(-T // tile)):
            t_out = ti * tile
            t_oct = t0 + t_out
            n_out = min(tile, T - t_out)
            live = max(0, min(n_out, frames - t_oct))
            q_first = t_oct * s - left
            if live == 0:
                continue
            f = np.arange(live)[:, None]
            q = q_first + np.arange((live - 1) * s + 512)
            ok = (q >= 0) & (q < cut)
            span = np.where(ok, x[:, np.clip(q, 0, n - 1)], 0.0)
            fr = span[:, f * s + np.arange(512)]
            # thread t, point j: z[t + 16 j] = fr[2 (t + 16 j)] + i fr[+1]
            z = (fr[..., 0::2] + 1j * fr[..., 1::2]).reshape(
                batch, live, 16, 16)                     # [..., j, t]
            # thread t's column DFT, then the table's W_256^(k1 t)
            v = np.einsum("kj,bfjt->bfkt", W16, z) * tbl.reshape(16, 16)
            # ex[k1 * 17 + t] = v[k1]; thread t reads ex[t * 17 + j], row
            # k1 = t, and its row DFT leaves Z[t + 16 k2] at u[t, k2]
            u = np.einsum("kj,bftj->bftk", W16, v)
            # the partner Z[256 - k]: thread 16 - t's u[15 - k2], by
            # shuffle; thread 0 its own u[(16 - k2) mod 16]
            part = u[:, :, src, 15 - k2_]
            part[:, :, 0, :] = u[:, :, 0, (16 - np.arange(16)) & 15]
            zk = u
            e = 0.5 * (zk.real + part.real) + 0.5j * (zk.imag - part.imag)
            d = 0.5 * (zk.imag + part.imag) + 0.5j * (part.real - zk.real)
            X = e + tw[kk % 512] * d
            xs = np.zeros((batch, tile, xs_stride), np.complex128)
            keep = col_kept & (kk >= lo) & (kk < hi)
            for tt, kc in zip(*np.nonzero(keep)):
                xs[:, :live, kk[tt, kc] - lo] = X[:, :, tt, kc]
            if hi > 256:
                z0 = u[:, :, 0, 0]
                xs[:, :live, 256 - lo] = z0.real - z0.imag
            for r in range(bpo):
                a, ln, off = meta[o, r]
                row = o * bpo + r
                acc = xs[:, :live, a - lo:a - lo + ln] @ vals[off:off + ln]
                out[:, row, t_out:t_out + live] = acc * sc[row]
    return out.reshape(levels[0].shape[:-1] + out.shape[1:])


def _float64_cqt(levels, slides, kernels, scale, *, T, t0=0, left=256):
    """The CQT of the same levels in float64 by numpy: padding, frames,
    rfft at 512, the dense kernels, scale; the kernel model's yardstick."""
    blocks = []
    for x, s, k in zip(levels, slides, kernels):
        x = x.double().numpy()
        n = x.shape[-1]
        cut = n // s * s
        xp = np.concatenate([np.zeros(x.shape[:-1] + (left,)), x[..., :cut],
                             np.zeros(x.shape[:-1] + (512 - left,))], -1)
        frames = n // s + 1
        idx = (t0 + np.arange(T))[:, None] * s + np.arange(512)
        valid = (t0 + np.arange(T)) < frames
        fr = xp[..., np.clip(idx, 0, xp.shape[-1] - 1)] * valid[:, None]
        S = np.fft.rfft(fr, axis=-1)
        blocks.append(S @ k.astype(np.complex128).T)
    out = np.concatenate(blocks, -1) * scale.numpy().astype(np.float64)
    return np.swapaxes(out, -1, -2)


def _hold(got, ref, tol, label):
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"{label}: {err:.3e} of the peak")
    assert err <= tol, label


CASES = {
    "cell": (lambda: aft.CQT(device="cpu", **CELL), (2, 24000), {}),
    "vqt": (lambda: aft.VQT(device="cpu"), (2, 24000), {}),
    "vqt_band_width": (lambda: _vqt_band_width("cpu"), (2, 24000), {}),
    "simple": (lambda: aft.SimpleCQT(device="cpu"), (1, 24001), {}),
    # odd slides 101 .. 1 (two scalar reads a point)
    "odd_slides": (lambda: aft.CQT(num=84, slide_length=101, device="cpu"),
                   (2, 9999), {}),
    # slide 1024 on 4,096-sample clips: the span of the call's 5 frames
    "long_slide": (lambda: aft.CQT(num=84, slide_length=1024, device="cpu"),
                   (2, 4096), {}),
    # a frame range past some octaves' last frames, inside one tile
    "frames": (lambda: aft.CQT(device="cpu", **CELL), (1, 9000),
               dict(t0=60, T=21)),
    # several tiles, the last one partial
    "three_clips": (lambda: aft.CQT(device="cpu", **CELL), (3, 12345), {}),
    # continue mode pads RIGHT: no zeros before the cut level
    "right": (lambda: aft.CQT(device="cpu", **CELL), (2, 8000),
              dict(left=0)),
    # 36 bins an octave at a plan of 512 points, 3 octaves
    "bpo36": (lambda: aft.CQT(num=108, bin_per_octave=36, low_fre=1000.0,
                              device="cpu"), (2, 7000), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_model(name):
    """The model of the kernel's indices against a float64 CQT of the same
    levels (1e-12 of the peak: only the order of float64 roundings
    differs), and against the plain float32 path (float32 rounding)."""
    make, shape, kw = CASES[name]
    kw = dict(kw)
    plan = make()
    assert plan.fft_length == 512
    x = torch.from_numpy(_signal(shape, seed=len(name)))
    levels = _levels(plan, x)
    slides = plan._octave_slides()
    T = kw.pop("T", shape[-1] // plan.slide_length + 1)
    t0 = kw.get("t0", 0)
    got = _model(levels, slides, plan._kernels_t, plan._scale_t, T=T, **kw)
    left = kw.get("left", 256)
    ref64 = _float64_cqt(levels, slides, plan._kernels, plan._scale_t, T=T,
                         t0=t0, left=left)
    _hold(got, ref64, 1e-12, f"{name}: model vs float64")
    plain = cuda_cqt.cqt_octaves_ref(levels[::-1], slides, plan._kernels_t,
                                     plan._scale_t, fft_length=512, T=T,
                                     t0=t0, center=left == 256).numpy()
    _hold(got, plain, 2e-6, f"{name}: model vs the plain float32 path")


def test_exchange_and_kept_bins_are_conflict_free():
    """The exchange's rows of 17 floats (a warp's two groups 272 floats
    apart) and a frame's kept bins at an odd stride: the column writes and
    the row reads of a warp hit 32 distinct banks, and 16 lanes (a
    half-warp's 64-bit access) of the product's reads too."""
    def banks(words):
        return {w % 32 for a in words for w in (2 * a, 2 * a + 1)}
    for k1 in range(16):            # column writes: ex[g 272 + k1 17 + t]
        assert len({(g * 272 + k1 * 17 + t) % 32 for g in (0, 1)
                    for t in range(16)}) == 32
    for j in range(16):             # row reads: ex[g 272 + t 17 + j]
        assert len({(g * 272 + t * 17 + j) % 32 for g in (0, 1)
                    for t in range(16)}) == 32
    for width in range(1, 258):
        stride = width | 1
        for j in (0, width - 1):    # the product: xs[f * stride + j]
            assert len(banks([f * stride + j for f in range(16)])) == 32


def test_shared_memory_fits_at_the_cells_plan(cell):
    """cqt.cu's sizing at the cell's plan: the staged span, the exchange
    and the kept bins of a block fit three times on an SM (228 KB, 1 KB
    reserved a block) at its tile of 64 frames."""
    tile = cuda_cqt.TILE
    span = ((tile - 1) * 128 + 512 + 3) & ~3
    smem = 8 * 256 + 4 * span + 4 * 16 * 16 * 17 + 8 * tile * (
        (cell._kernels_t.hi - cell._kernels_t.lo) | 1)
    assert span <= SPAN_MAX and 3 * (smem + 1024) <= 228 * 1024


def test_shared_memory_fits_at_any_span_that_fits():
    """The largest block cqt.cu can ask for (a span of SPAN_MAX floats
    and all 257 bins kept) is within a block's shared memory on sm_90, so
    the span is the one rule ``supports`` keeps."""
    smem = 8 * 256 + 4 * SPAN_MAX + 4 * 16 * 16 * 17 + 8 * cuda_cqt.TILE * (
        257 | 1)
    assert smem <= SMEM_MAX


# ----------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda:0")


CARD_TOL = 1e-5        # of each result's peak: float32 rounding


def _plain(plan, x, monkeypatch):
    """The plan's call with the kernel's route refused: today's path."""
    with monkeypatch.context() as m:
        m.setattr(cuda_cqt, "supports", lambda *a: False)
        return plan.cqt(x)


def _err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.card
def test_the_cells_plan_on_the_card(card, monkeypatch):
    """Four 30 s clips of the benchmark's traffic: the kernel against the
    plain path, within float32 rounding; the same outputs twice."""
    from benchmark import traffic
    x = traffic.mir((4, 30 * SR), traffic.generator(3400002701, card), card,
                    SR)
    p = aft.CQT(device=card, **CELL)
    got = p.cqt(x)
    assert got.shape == (4, 84, 7501) and got.dtype == torch.complex64
    err = _err(got, _plain(p, x, monkeypatch))
    print(f"cell 4 x 30 s: {err:.3e} of the peak")
    assert err <= CARD_TOL
    assert torch.equal(got, p.cqt(x))


@pytest.mark.card
@pytest.mark.parametrize("name,make,shape", [
    ("vqt", lambda d: aft.VQT(device=d), (2, 10 * SR)),
    ("vqt band width", _vqt_band_width, (2, 10 * SR)),
    ("simple", lambda d: aft.SimpleCQT(device=d), (2, 10 * SR)),
    ("odd length", lambda d: aft.CQT(device=d, **CELL), (3, 100001)),
    ("1-D", lambda d: aft.CQT(device=d, **CELL), (5 * SR + 77,)),
    ("3-D", lambda d: aft.CQT(device=d, **CELL), (2, 3, 3 * SR + 5)),
    ("odd slides", lambda d: aft.CQT(num=84, slide_length=101, device=d),
     (2, 4 * SR)),
    ("long slide", lambda d: aft.CQT(num=84, slide_length=1024, device=d),
     (2, 4096)),
    ("bpo36", lambda d: aft.CQT(num=108, bin_per_octave=36, low_fre=1000.0,
                                device=d), (2, 2 * SR)),
])
def test_plans_and_shapes_on_the_card(card, monkeypatch, name, make, shape):
    p = make(card)
    assert p.fft_length == 512
    x = torch.from_numpy(_signal(shape, seed=7)).to(card)
    T = shape[-1] // p.slide_length + 1
    assert cuda_cqt.supports(x, 512, p._octave_slides(), T), name
    got = p.cqt(x)
    ref = _plain(p, x, monkeypatch)
    assert got.shape == ref.shape
    err = _err(got, ref)
    print(f"{name} {shape}: {err:.3e} of the peak")
    assert err <= CARD_TOL, name


@pytest.mark.card
def test_frame_ranges_and_continue_on_the_card(card, monkeypatch):
    """``_cqt_frames`` (the frame-sharded body) and continue mode (RIGHT
    padding, the carried tail) take the kernel too."""
    x = torch.from_numpy(_signal((2, 6 * SR), seed=8)).to(card)
    p = aft.CQT(device=card, **CELL)
    full = p.cqt(x)
    for t0, t1 in ((0, 64), (700, 1501), (1490, 1530)):
        part = p._cqt_frames(x, t0, t1)
        with monkeypatch.context() as m:
            m.setattr(cuda_cqt, "supports", lambda *a: False)
            ref = p._cqt_frames(x, t0, t1)
        assert _err(part, ref) <= CARD_TOL, (t0, t1)
        assert _err(part[..., :max(0, 1501 - t0)],
                    full[..., t0:t1]) <= CARD_TOL
    a = aft.CQT(device=card, is_continue=True, **CELL)
    b = aft.CQT(device=card, is_continue=True, **CELL)
    for lo, hi in ((0, 3000), (3000, 50000), (50000, 6 * SR)):
        got = a.cqt(x[:, lo:hi])
        ref = _plain(b, x[:, lo:hi], monkeypatch)
        assert got.shape == ref.shape
        if ref.numel():
            assert _err(got, ref) <= CARD_TOL, (lo, hi)


@pytest.mark.card
def test_one_call_launches_the_kernel_once(card):
    """One ``CQT.cqt`` at the cell's plan launches the kernel once and
    calls no library FFT."""
    from audioflux_torch.ops import fft as afft
    x = torch.from_numpy(_signal((2, 30 * SR), seed=9)).to(card)
    p = aft.CQT(device=card, **CELL)
    before = (cuda_cqt.cqt_octaves.launches, afft.rfft.library_calls)
    C = p.cqt(x)
    torch.cuda.synchronize(card)
    assert (cuda_cqt.cqt_octaves.launches - before[0],
            afft.rfft.library_calls - before[1]) == (1, 0)
    assert C.shape == (2, 84, 7501)
