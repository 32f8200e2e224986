"""The port's reassignment on the CPU (``device="cpu"``) against the JAX
package on the CPU and against the reference C goldens.

Reassignment rounds each corrected float32 frequency and time to a grid
index and scatter-adds there.  Two math libraries (or two complex-division
algorithms) an ulp apart move a cell that sits a rounding away from a
bin edge into the neighbouring bin, so results are compared by the
benchmark's own gate (``bench.py:285-313``): the share of cells off by
more than 1e-3 of the peak (flips) at most 5e-3, and the summed magnitude
within 1e-4 (mass).  The windows and the plain STFT, computed the same
way in both packages, are compared exactly or at 1e-5."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.ops.window import get_fft_window
from audioflux_tpu.transforms import reassign as jr
from audioflux_tpu.types import ReassignType as RT, WindowType
from audioflux_torch.transforms import reassign as tr
from tests.conftest import assert_close_to_golden

SR = 32000
CPU = {"device": "cpu"}
FLIP_TOL, FLIP_SHARE, MASS_TOL = 1e-3, 5e-3, 1e-4


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_flips_and_mass(got, ref, label):
    got, ref = np.abs(_np(got)).astype(np.float64), np.abs(_np(ref))
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    peak = ref.max()
    flips = np.mean(np.abs(got - ref) > FLIP_TOL * peak)
    mass = abs(got.sum() / max(ref.sum(), 1e-30) - 1)
    assert flips <= FLIP_SHARE and mass <= MASS_TOL, (
        f"{label}: flips {flips:.3e}, mass {mass:.3e}")


def _pair(**kw):
    return af.Reassign(**kw), aft.Reassign(**kw, **CPU)


@pytest.mark.parametrize("window", list(WindowType))
def test_reassign_windows_equal(window):
    w = get_fft_window(window, 512)
    for a, b in zip(tr.reassign_windows(w), jr.reassign_windows(w)):
        assert np.array_equal(a, b)


# (label, Reassign kwargs, clips, samples, order, result type): every
# correction type, padding, orders 1-3, both result types, one frame
_CASES = [
    ("all", dict(radix2_exp=11, slide_length=512), 2, 12000, 1, 0),
    ("all_real", dict(radix2_exp=11, slide_length=512), 2, 12000, 1, 1),
    ("fre_hamm", dict(radix2_exp=10, slide_length=256, re_type=RT.FRE,
                      window_type=WindowType.HAMM), 1, 8000, 1, 0),
    ("time", dict(radix2_exp=10, slide_length=300, re_type=RT.TIME), 1,
     8000, 1, 1),
    ("padded", dict(radix2_exp=10, slide_length=256, is_padding=True), 2,
     7000, 1, 0),
    ("order2", dict(radix2_exp=10, slide_length=256), 1, 8000, 2, 0),
    ("order3_real", dict(radix2_exp=10, slide_length=256), 1, 8000, 3, 1),
    ("one_frame", dict(radix2_exp=12, slide_length=1024), 3, 4096, 1, 1),
    ("one_frame_thresh", dict(radix2_exp=11, slide_length=512,
                              thresh=0.01), 2, 2100, 1, 0),
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c[0])
def test_reassign_matches_jax(case, signals):
    label, kw, clips, n, order, rt = case
    j, t = _pair(samplate=SR, **kw)
    for plan in (j, t):
        plan.set_order(order)
        plan.set_result_type(rt)
    x = np.stack([signals["chord"][:n], signals["sine"][:n],
                  signals["chirp"][:n]])[:clips]
    got, stft = t.reassign(x, with_stft=True)
    ref, stft_j = j.reassign(x, with_stft=True)
    assert got.dtype == (torch.complex64 if rt == 0 else torch.float32)
    assert got.shape[-1] == t.cal_time_length(n) == j.cal_time_length(n)
    assert_flips_and_mass(got, ref, label)
    if rt == 0:
        assert_flips_and_mass(_np(got).real, np.asarray(ref).real,
                              f"{label} real part")
    np.testing.assert_allclose(_np(stft), np.asarray(stft_j), rtol=0,
                               atol=1e-5 * np.abs(stft_j).max())
    assert np.array_equal(t.y_coords(), j.y_coords())


def test_reassign_none_is_the_stft(signals):
    j, t = _pair(radix2_exp=10, samplate=SR, slide_length=256,
                 re_type=RT.NONE)
    x = signals["sine"][:6000]
    got, stft = t.reassign(x, with_stft=True)
    assert got is stft
    ref = np.asarray(j.reassign(x))
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_reassign_against_the_jax_kernel_route():
    """The port's natural-order route against JAX's four-step kernel route
    (Pallas in interpret mode, T-layout bins) on a tiny case."""
    rng = np.random.default_rng(5)
    x = (0.2 * rng.standard_normal((1, 2048 + 512))).astype(np.float32)
    t = aft.Reassign(radix2_exp=11, samplate=SR, slide_length=512, **CPU)
    got, stft = t.reassign(x, with_stft=True)
    ref, stft_j = jr._reassign_impl(
        jnp.asarray(x), jnp.asarray(t._wins), fft_length=2048,
        slide_length=512, samplate=SR, thresh=0.001, re_type=0, order=1,
        result_type=0, is_padding=False, use_kernel=True, interpret=True)
    assert_flips_and_mass(got, ref, "kernel route")
    np.testing.assert_allclose(_np(stft), np.asarray(stft_j), rtol=0,
                               atol=5e-5 * np.abs(stft_j).max())


@pytest.mark.parametrize("key,re_type", [("reassign", RT.ALL),
                                         ("reassign_fre", RT.FRE)])
def test_reassign_golden(key, re_type, goldens, signals):
    g = goldens("bft")
    t = aft.Reassign(radix2_exp=11, samplate=SR, slide_length=512,
                     re_type=re_type, **CPU)
    D = _np(t.reassign(signals["chord"][:16000]))
    assert_close_to_golden(D.real, g[f"{key}_re"], 2e-4, f"{key}_re")
    assert_close_to_golden(D.imag, g[f"{key}_im"], 2e-4, f"{key}_im")


@pytest.mark.parametrize("i", range(5))
def test_fuzz_reassign_golden(goldens, signals, i):
    """tests/test_fuzz_goldens.py's criterion: fewer than 1e-3 of the
    cells off by 2e-4 of the peak, the complex sum within 2e-4."""
    g = goldens("fuzz_reassign")
    p = json.loads(str(g[f"c{i}_params"]))
    t = aft.Reassign(radix2_exp=p["r2e"], samplate=SR,
                     window_type=getattr(WindowType, p["window"]),
                     slide_length=p["slide"],
                     re_type=getattr(RT, p["re_type"]), thresh=0.001,
                     is_padding=p["pad"], **CPU)
    D = _np(t.reassign(signals["sine"][:8192]))
    ref = g[f"c{i}_re"] + 1j * g[f"c{i}_im"]
    peak = np.abs(ref).max()
    assert (np.abs(D - ref) > 2e-4 * peak).mean() < 1e-3, p
    np.testing.assert_allclose(D.sum(), ref.sum(), rtol=2e-4,
                               atol=2e-4 * peak)


def test_reassign_rejects_and_keeps_order():
    with pytest.raises(ValueError):
        aft.Reassign(radix2_exp=1, **CPU)
    t = aft.Reassign(radix2_exp=10, **CPU)
    t.set_order(0)
    assert t.order == 1
    assert t.slide_length == 256
