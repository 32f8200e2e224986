"""The port's Synsq and WSST on the CPU (``device="cpu"``) against the JAX
package on the CPU and the reference C goldens.

Synchrosqueezing scatters each cell to a bin chosen by rounding a float32
atan2 / log2 chain.  An ulp of difference between two math libraries, or a
multiply-add that a compiler contracts (XLA's jitted CPU code does, the
port's op-by-op code does not), moves a small share of boundary cells to a
neighbouring bin.  So the comparisons use tests/test_synsq.py's two
criteria (share of cells within 1e-4 of the peak; scattered energy within
1e-3), not ``allclose``.  The bin maps themselves, computed op by op in
both packages from the same input, are compared exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.transforms import synsq as js
from audioflux_tpu.transforms import wsst as jw
from audioflux_tpu.types import (SpectralFilterBankScaleType as S,
                                 WaveletContinueType as W)
from audioflux_torch.ops.cuda_scatter import columnar_scatter
from audioflux_torch.ops.cuda_unwrap import bin_map, unwrap_diff
from audioflux_torch.transforms import synsq as ts
from audioflux_torch.transforms import wsst as tw

CPU = {"device": "cpu"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_scatter_close(ours, ref, name, cell_frac=0.995, energy_rtol=1e-3):
    ours, ref = _np(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    match = np.abs(ours - ref) <= 1e-4 * max(np.abs(ref).max(), 1e-20)
    frac = match.mean()
    assert frac >= cell_frac, f"{name}: only {frac:.4%} of cells match"
    e1 = (np.abs(ours) ** 2).sum()
    e2 = (np.abs(ref) ** 2).sum()
    assert abs(e1 - e2) <= energy_rtol * e2, f"{name}: energy {e1} vs {e2}"


def _noise(shape, seed=12):
    return (0.2 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------------------------------------------ synsq

def test_synsq_golden_and_jax(goldens):
    g = goldens("synsq")
    C = g["in_re"] + 1j * g["in_im"]
    t = aft.Synsq(num=84, radix2_exp=12, samplate=32000, **CPU)
    R = t.synsq(C, S.OCTAVE, g["in_fre"])
    assert R.dtype == torch.complex64 and R.shape == (84, 4096)
    assert_scatter_close(R, g["synsq_re"] + 1j * g["synsq_im"], "golden")
    Rj = af.Synsq(num=84, radix2_exp=12, samplate=32000).synsq(
        C, S.OCTAVE, g["in_fre"])
    assert_scatter_close(R, np.asarray(Rj), "jax")


def test_synsq_batched_and_unwrap_forms(goldens):
    g = goldens("synsq")
    C = (g["in_re"] + 1j * g["in_im"]).astype(np.complex64)
    t = aft.Synsq(num=84, radix2_exp=12, samplate=32000, **CPU)
    single = _np(t.synsq(C, S.OCTAVE, g["in_fre"]))
    batch = _np(t.synsq(torch.from_numpy(np.stack([C, C])), S.OCTAVE,
                        g["in_fre"]))
    assert batch.shape == (2, 84, 4096)
    np.testing.assert_allclose(batch[0], single, atol=1e-6)
    np.testing.assert_allclose(batch[1], single, atol=1e-6)
    # on the CPU the kernel form's plain version and the pinned prefix-sum
    # form are the same arithmetic
    pinned = _np(t.synsq(C, S.OCTAVE, g["in_fre"], force_xla_unwrap=True))
    assert np.array_equal(pinned, single)


@pytest.mark.parametrize("scale,kind", [(S.OCTAVE, "log"), (S.LOG, "log"),
                                        (S.LINEAR, "linear"),
                                        (S.LINSPACE, "linear"),
                                        (S.MEL, "nearest"),
                                        (S.BARK, "nearest")])
def test_scale_kind(scale, kind):
    assert ts.scale_kind(scale) == js.scale_kind(scale) == kind


def test_scale_kind_refuses_chroma():
    with pytest.raises(ValueError):
        ts.scale_kind(S.CHROMA)


def _cwt_pair(scale, **kw):
    kw = dict(dict(num=48, radix2_exp=11, samplate=32000,
                   wavelet_type=W.MORLET, scale_type=scale), **kw)
    return af.CWT(**kw), aft.CWT(**kw, **CPU)


@pytest.mark.parametrize("scale", [S.OCTAVE, S.LINEAR, S.MEL])
@pytest.mark.parametrize("order", [1, 2])
def test_synsq_scale_kinds_and_orders(signals, scale, order):
    """All three bin-mapping families, order 1 and the order-2 composition,
    on a chirp plus noise; both packages squeeze the same CWT."""
    extra = dict(low_fre=100.0, high_fre=4000.0) if scale == S.LINEAR else {}
    j, t = _cwt_pair(scale, **extra)
    x = signals["chirp"][4096:4096 + 2048] + _noise(2048, 3) * 0.1
    D = np.array(j.cwt(x))
    fre = np.array(j.get_fre_band_arr())
    kind = js.scale_kind(scale)
    # the maps, op by op in both packages: equal cell for cell
    fj = np.asarray(js._compose_order(js._synsq_map(
        jnp.asarray(D), jnp.asarray(fre), scale_kind=kind, num=48,
        samplate=32000.0), 48, order))
    ft = _np(ts._compose_order(ts._synsq_map(
        torch.from_numpy(D), torch.from_numpy(fre), scale_kind=kind, num=48,
        samplate=32000.0), 48, order))
    assert ft.dtype == np.int32

    def ok(f):
        return (f >= 0) & (f < 48)
    assert np.array_equal(ok(fj), ok(ft))
    assert (fj[ok(fj)] == ft[ok(ft)]).mean() >= 0.999
    assert ok(ft).mean() > 0.3          # the map is not trivially empty
    Rj = af.Synsq(num=48, radix2_exp=11, order=order).synsq(D, scale, fre)
    Rt = aft.Synsq(num=48, radix2_exp=11, order=order, **CPU).synsq(
        D, scale, fre)
    assert float(Rt.abs().max()) > 0
    assert_scatter_close(Rt, np.asarray(Rj), f"{scale.name} order {order}")


def test_synsq_wide_bank_takes_the_flat_scatter():
    """num = 600 > 512: ``_reassign_scatter`` takes ``batched_scatter_add``;
    num = 500 takes the columnar form; both agree with the JAX package."""
    rng = np.random.default_rng(4)
    T = 64
    for num in (600, 500):
        D = (rng.standard_normal((2, num, T))
             + 1j * rng.standard_normal((2, num, T))).astype(np.complex64)
        D[0, :10] *= 1e-5                         # under the threshold
        fi = rng.integers(-2, num + 2, (2, num, T)).astype(np.int32)
        got = _np(ts._reassign_scatter(torch.from_numpy(D),
                                       torch.from_numpy(fi), num=num,
                                       thresh=0.001))
        want = np.asarray(js._reassign_scatter(jnp.asarray(D),
                                               jnp.asarray(fi), num=num,
                                               thresh=0.001))
        assert got.shape == (2, num, T)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["log", "linear", "nearest"])
def test_bin_map_int_cast_edges(kind):
    """Zeros (log2 -> -inf), a rate far past int32 and NaN never reach the
    float -> int cast: the cells come out as -1, and a squeeze of zeros is
    all zeros like the JAX package's."""
    num = 16
    fre = np.linspace(100.0, 8000.0, num).astype(np.float32)
    if kind == "linear":       # a band layout so narrow that fi ~ 1e30
        fre = (100.0 + np.arange(num) * 1e-30).astype(np.float32)
        fre[-1] = np.nextafter(np.float32(100.0), np.float32(200.0))
    v = torch.tensor([0.0, 1e-45, 0.01, 0.2, 3e38, float("inf"),
                      float("nan"), -0.05])
    fi = bin_map(v, torch.from_numpy(fre), scale_kind=kind, num=num,
                 samplate=32000.0)
    assert fi.dtype == torch.int32
    fi = fi.numpy()
    assert ((fi >= -1) & (fi < num)).all()
    assert fi[0] == -1 or kind == "linear"      # |0 - fmin| is a finite bin
    assert (fi[[4, 5, 6]] == -1).all()
    # the squeeze of an all-zero transform, against the JAX package
    D = np.zeros((num, 32), np.complex64)
    scale = {"log": S.OCTAVE, "linear": S.LINEAR, "nearest": S.MEL}[kind]
    got = _np(aft.Synsq(num=num, radix2_exp=5, **CPU).synsq(D, scale, fre))
    want = np.asarray(af.Synsq(num=num, radix2_exp=5).synsq(D, scale, fre))
    assert np.array_equal(got, want) and not got.any()


def test_huge_rate_drops_like_jax():
    """Cells whose bin lies far outside the layout drop in both packages
    (the JAX cast saturates; the port decides on the float)."""
    rng = np.random.default_rng(6)
    num, T = 12, 256
    D = (rng.standard_normal((num, T))
         + 1j * rng.standard_normal((num, T))).astype(np.complex64)
    fre = (50.0 + np.arange(num) * 1e-4).astype(np.float32)  # fi ~ 1e7 * v
    got = _np(aft.Synsq(num=num, radix2_exp=8, **CPU).synsq(D, S.LINEAR, fre))
    want = np.asarray(af.Synsq(num=num, radix2_exp=8).synsq(D, S.LINEAR, fre))
    assert_scatter_close(got, want, "huge rate", cell_frac=0.999)


# ------------------------------------------------------------------- wsst

def test_wsst_golden_and_jax(goldens, signals):
    g = goldens("synsq")
    kw = dict(num=84, radix2_exp=12, samplate=32000, wavelet_type=W.MORSE,
              scale_type=S.OCTAVE)
    t = aft.WSST(**kw, **CPU)
    x = signals["chord"][:4096]
    A, B = t.wsst(x)
    refB = g["wsst_cwt_re"] + 1j * g["wsst_cwt_im"]
    np.testing.assert_allclose(_np(B), refB, atol=1e-4)
    assert_scatter_close(A, g["wsst_sq_re"] + 1j * g["wsst_sq_im"], "golden",
                         cell_frac=0.999)
    Aj, Bj = af.WSST(**kw).wsst(x)
    assert np.abs(_np(B) - np.asarray(Bj)).max() <= 1e-5 * np.abs(Bj).max()
    assert_scatter_close(A, np.asarray(Aj), "jax", cell_frac=0.999)
    np.testing.assert_allclose(t.get_fre_band_arr(), g["in_fre"], rtol=1e-5)
    assert np.array_equal(t.y_coords(), t.get_fre_band_arr())
    assert t.x_coords().shape == (4096,)


@pytest.mark.parametrize("scale,order", [(S.MEL, 1), (S.LINEAR, 1),
                                         (S.OCTAVE, 2)])
def test_wsst_scales_and_order(signals, scale, order):
    extra = dict(low_fre=100.0, high_fre=4000.0) if scale == S.LINEAR else {}
    kw = dict(num=40, radix2_exp=11, samplate=32000, wavelet_type=W.MORLET,
              scale_type=scale, **extra)
    j, t = af.WSST(**kw), aft.WSST(**kw, **CPU)
    j.set_order(order)
    t.set_order(order)
    t.set_order(0)                       # ignored, as in the JAX package
    assert t.order == order
    x = np.stack([signals["chirp"][2048:4096], signals["chord"][:2048]])
    (A, B), (Aj, Bj) = t.wsst(x), j.wsst(x)
    assert A.shape == B.shape == (2, 40, 2048)
    assert np.abs(_np(B) - np.asarray(Bj)).max() <= 1e-5 * np.abs(Bj).max()
    assert_scatter_close(A, np.asarray(Aj), f"{scale.name} order {order}")


def test_wsst_map_zero_cells():
    """D == 0 divides by 1 (no NaN reaches the map)."""
    D = torch.zeros((4, 8), dtype=torch.complex64)
    dD = torch.ones((4, 8), dtype=torch.complex64) * 1j
    fre = np.linspace(100, 4000, 4).astype(np.float32)
    got = _np(tw._wsst_map(D, dD, torch.from_numpy(fre), scale_kind="log",
                           num=4, samplate=32000.0))
    want = np.asarray(jw._wsst_map(jnp.asarray(_np(D)), jnp.asarray(_np(dD)),
                                   jnp.asarray(fre), scale_kind="log", num=4,
                                   samplate=32000.0))

    def ok(f):
        return (f >= 0) & (f < 4)
    assert np.array_equal(ok(got), ok(want))
    assert np.array_equal(got[ok(got)], want[ok(want)])


# --------------------------------------------------- the slice as a whole

def test_slice_cwt_then_synsq_on_noise():
    """|synsq(cwt(x))| of both packages on two noise clips at radix2_exp
    12: the wavelet path of the benchmark (morlet, octave, 84 bands) at a
    small size.  Flips (cells off by more than 1e-5 of the peak) <= 5e-3
    and mass within 1e-4, the benchmark's own gate."""
    x = _noise((2, 4096))
    kw = dict(num=84, radix2_exp=12, samplate=32000, wavelet_type=W.MORLET,
              scale_type=S.OCTAVE)
    jc, tc = af.CWT(**kw), aft.CWT(**kw, **CPU)
    jsq = af.Synsq(num=84, radix2_exp=12, samplate=32000)
    tsq = aft.Synsq(num=84, radix2_exp=12, samplate=32000, **CPU)
    before = (unwrap_diff.launches, columnar_scatter.launches)
    yj = np.abs(np.asarray(jsq.synsq(jc.cwt(x), S.OCTAVE,
                                     jc.get_fre_band_arr())))
    yt = _np(tsq.synsq(tc.cwt(x), S.OCTAVE, tc.get_fre_band_arr()).abs())
    assert (unwrap_diff.launches, columnar_scatter.launches) == before
    assert yt.shape == yj.shape == (2, 84, 4096) and np.isfinite(yt).all()
    peak = yj.max()
    flips = (np.abs(yt - yj) > 1e-5 * peak).mean()
    mass = abs(yt.sum() / yj.sum() - 1)
    assert flips <= 5e-3, flips
    assert mass <= 1e-4, mass
    assert_scatter_close(yt, yj, "slice")
