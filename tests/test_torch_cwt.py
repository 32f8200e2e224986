"""The port's CWT and PWT on the CPU (``device="cpu"``) against the JAX
package on the CPU and the reference C goldens (the tolerances of
tests/test_cwt.py and tests/test_pwt.py)."""

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.transforms.cwt import cwt_filter_bank as j_filter_bank
from audioflux_tpu.types import (SpectralFilterBankScaleType as S,
                                 WaveletContinueType as W)
from audioflux_torch.transforms.cwt import _symmetric_pad
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}

CASES = {
    "morse_oct": dict(wavelet_type=W.MORSE, scale_type=S.OCTAVE),
    "morlet_oct": dict(wavelet_type=W.MORLET, scale_type=S.OCTAVE),
    "bump_oct": dict(wavelet_type=W.BUMP, scale_type=S.OCTAVE),
    "paul_oct": dict(wavelet_type=W.PAUL, scale_type=S.OCTAVE),
    "dog_oct": dict(wavelet_type=W.DOG, scale_type=S.OCTAVE),
    "mexican_oct": dict(wavelet_type=W.MEXICAN, scale_type=S.OCTAVE),
    "hermit_oct": dict(wavelet_type=W.HERMIT, scale_type=S.OCTAVE),
    "ricker_oct": dict(wavelet_type=W.RICKER, scale_type=S.OCTAVE),
    "morse_linear": dict(wavelet_type=W.MORSE, scale_type=S.LINEAR,
                         num=64, low_fre=100.0, high_fre=8000.0),
    "morse_mel": dict(wavelet_type=W.MORSE, scale_type=S.MEL, num=64),
    "morse_nopad": dict(wavelet_type=W.MORSE, scale_type=S.OCTAVE,
                        is_padding=False),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(cls, **kw):
    return getattr(af, cls)(**kw), getattr(aft, cls)(**kw, **CPU)


@pytest.mark.parametrize("name", list(CASES))
def test_cwt_case(goldens, signals, name):
    """The bank equal array for array; ``cwt`` within 1e-5 of the peak of
    the JAX package's and within the golden's 2e-4."""
    g = goldens("cwt")
    kw = dict(CASES[name])
    kw.setdefault("num", 84)
    j, t = _pair("CWT", radix2_exp=12, samplate=32000, **kw)
    assert t._bank.dtype == np.float32
    assert np.array_equal(t._bank, j._bank)
    assert np.array_equal(t.get_fre_band_arr(), j.get_fre_band_arr())
    assert np.array_equal(t.get_bin_band_arr(), j.get_bin_band_arr())
    assert t.pad_length == j.pad_length and t._row_h == j._row_h
    np.testing.assert_allclose(t.get_fre_band_arr(), g[f"{name}_fre"],
                               rtol=1e-5, atol=1e-2)
    x = signals["chord"][:4096]
    C = _np(t.cwt(x))
    assert C.dtype == np.complex64
    Cj = np.asarray(j.cwt(x))
    assert np.abs(C - Cj).max() <= 1e-5 * np.abs(Cj).max()
    ref = g[f"{name}_re"] + 1j * g[f"{name}_im"]
    assert_close_to_golden(C.real, ref.real, 2e-4, f"{name}_re")
    assert_close_to_golden(C.imag, ref.imag, 2e-4, f"{name}_im")


def test_cwt_filter_bank_function_equals_jax():
    args = (40, 2048, 16000, 1024, W.PAUL, 4.0, 20.0, S.LOG, 50.0, 7000.0)
    for a, b in zip(aft.cwt_filter_bank(*args), j_filter_bank(*args)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("radix2_exp", [10, 13])
def test_cwt_det(signals, radix2_exp):
    """The derivative bank and ``cwt_det``: radix2_exp 10 multiplies and
    takes ``ops.fft.ifft``, 13 (padded length 16384) goes through the
    ``cwt_ifft_bank`` wrapper's plain version."""
    j, t = _pair("CWT", num=16, radix2_exp=radix2_exp, samplate=32000)
    x = signals["chord"][:1 << radix2_exp]
    D, Dj = _np(t.cwt_det(x)), np.asarray(j.cwt_det(x))
    assert np.array_equal(t._det_bank, j._det_bank)
    assert t._det_row_h == j._det_row_h
    assert D.shape == (16, 1 << radix2_exp) and np.isfinite(D).all()
    assert np.abs(D - Dj).max() <= 1e-5 * np.abs(Dj).max()
    C, Cj = _np(t.cwt(x)), np.asarray(j.cwt(x))
    assert np.abs(C - Cj).max() <= 1e-5 * np.abs(Cj).max()


def test_cwt_batched(signals):
    t = aft.CWT(num=32, radix2_exp=12, samplate=32000, **CPU)
    x = signals["chord"][:4096]
    out = _np(t.cwt(np.stack([x, 2 * x])))
    single = _np(t.cwt(x))
    assert out.shape == (2, 32, 4096)
    np.testing.assert_allclose(out[0], single, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(out[1], 2 * single, rtol=1e-5, atol=1e-8)
    lead = _np(t.cwt(torch.from_numpy(np.stack([x, x]).reshape(1, 2, 4096))))
    assert lead.shape == (1, 2, 32, 4096)
    with pytest.raises(ValueError):
        t.cwt(x[:1000])


def test_ccwt_three_windows(signals):
    """The half-window splice over 3 windows (4 half-steps of signal)."""
    j, t = _pair("CWT", num=24, radix2_exp=10, samplate=32000,
                 wavelet_type=W.MORLET)
    x = signals["chirp"][:4 * 512]
    assert (len(x) // 512) - 1 == 3
    got, want = _np(t.ccwt(x)), np.asarray(j.ccwt(x))
    assert got.shape == want.shape == (24, 2048)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        t.ccwt(x[:1023])


def test_symmetric_pad_repeats_the_edge():
    x = torch.arange(12.0).reshape(2, 6)
    got = _symmetric_pad(x, 3).numpy()
    want = np.pad(x.numpy(), [(0, 0), (3, 3)], mode="symmetric")
    assert np.array_equal(got, want)


def test_constructor_rules():
    j, t = _pair("CWT", num=20, radix2_exp=17, samplate=32000)
    assert t.pad_length == j.pad_length == 17      # ceil(log2) above 1e5
    assert t._row_h is None and j._row_h is None   # not a power of two
    for bad in (dict(scale_type=S.DEEP), dict(num=1),
                dict(scale_type=S.OCTAVE, low_fre=10.0),
                dict(wavelet_type=W.DOG, gamma=3.0),
                dict(num=200, radix2_exp=12)):
        with pytest.raises(ValueError):
            aft.CWT(**bad, **CPU)
        with pytest.raises(ValueError):
            af.CWT(**bad)
    with pytest.raises(ValueError):
        aft.PWT(scale_type=S.CHROMA, **CPU)


@pytest.mark.parametrize("name,kw", [
    ("oct", dict(num=84, scale_type=S.OCTAVE)),
    ("mel", dict(num=64, scale_type=S.MEL)),
])
def test_pwt(goldens, signals, name, kw):
    g = goldens("pwt")
    j, t = _pair("PWT", radix2_exp=12, samplate=32000, **kw)
    assert np.array_equal(t._bank, j._bank)
    assert np.array_equal(t.get_fre_band_arr(), j.get_fre_band_arr())
    assert np.array_equal(t.get_bin_band_arr(), j.get_bin_band_arr())
    x = signals["chord"][:4096]
    C, Cj = _np(t.pwt(x)), np.asarray(j.pwt(x))
    assert np.abs(C - Cj).max() <= 1e-5 * np.abs(Cj).max()
    ref = g[f"{name}_re"] + 1j * g[f"{name}_im"]
    assert_close_to_golden(C.real, ref.real, 2e-4, f"{name}_re")
    assert_close_to_golden(C.imag, ref.imag, 2e-4, f"{name}_im")


def test_pwt_through_the_kernel_wrapper(signals):
    """radix2_exp 13: the padded length 16384 lies in the kernel's domain,
    so the call goes through ``cwt_ifft_bank`` (its plain version here)
    with the real pseudo-auditory bank and its support rows."""
    j, t = _pair("PWT", num=32, radix2_exp=13, samplate=32000,
                 scale_type=S.MEL)
    assert t._row_h == j._row_h and t._row_h is not None
    x = np.stack([signals["chord"][:8192], signals["sine"][:8192]])
    C, Cj = _np(t.pwt(x)), np.asarray(j.pwt(x))
    assert C.shape == (2, 32, 8192)
    assert np.abs(C - Cj).max() <= 1e-5 * np.abs(Cj).max()


def test_load_reference_constants_round_trip(signals):
    """A JAX plan's banks installed on a port plan built with other
    parameters: the port then computes the JAX plan's transform."""
    x = signals["chord"][:8192]
    j = af.CWT(num=24, radix2_exp=13, wavelet_type=W.MORLET)
    j.enable_det(True)
    t = aft.CWT(num=24, radix2_exp=13, wavelet_type=W.PAUL, **CPU)
    assert not np.array_equal(t._bank, j._bank)
    aft.load_reference_constants(
        t, bank=j._bank, det_bank=j._det_bank, fre_band_arr=j.fre_band_arr,
        bin_band_arr=j.bin_band_arr, row_h=j._row_h, det_row_h=j._det_row_h)
    assert np.array_equal(t._bank, j._bank)
    assert np.array_equal(_np(t._bank_t), j._bank)
    assert np.array_equal(t._det_bank, j._det_bank)
    assert t._row_h == j._row_h and t._det_row_h == j._det_row_h
    for got, want in ((t.cwt(x), j.cwt(x)), (t.cwt_det(x), j.cwt_det(x))):
        want = np.asarray(want)
        assert np.abs(_np(got) - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError):      # support rows that do not fit
        aft.load_reference_constants(t, bank=j._bank, row_h=(16,) * 24)
    with pytest.raises(ValueError):      # a bank of another shape
        aft.load_reference_constants(t, bank=j._bank[:, :100])

    jp = af.PWT(num=32, radix2_exp=12, scale_type=S.MEL)
    tp = aft.PWT(num=32, radix2_exp=12, scale_type=S.BARK, **CPU)
    aft.load_reference_constants(tp, bank=jp._bank,
                                 fre_band_arr=jp.fre_band_arr,
                                 bin_band_arr=jp.bin_band_arr,
                                 row_h=jp._row_h)
    want = np.asarray(jp.pwt(x[:4096]))
    assert np.abs(_np(tp.pwt(x[:4096])) - want).max() <= 1e-5 * np.abs(want).max()

    jw = af.WSST(num=24, radix2_exp=12, wavelet_type=W.MORLET)
    tw = aft.WSST(num=24, radix2_exp=12, wavelet_type=W.MORSE, **CPU)
    aft.load_reference_constants(tw, bank=jw._cwt._bank,
                                 fre_band_arr=jw._cwt.fre_band_arr,
                                 bin_band_arr=jw._cwt.bin_band_arr)
    assert np.array_equal(tw._cwt._bank, jw._cwt._bank)
    assert np.array_equal(tw.get_fre_band_arr(), jw.get_fre_band_arr())


@pytest.mark.parametrize("make", [
    lambda **k: aft.CWT(radix2_exp=10, **k),
    lambda **k: aft.PWT(radix2_exp=10, **k),
    lambda **k: aft.WSST(radix2_exp=10, **k),
    lambda **k: aft.Synsq(num=84, radix2_exp=10, **k),
], ids=["CWT", "PWT", "WSST", "Synsq"])
def test_device_policy(make):
    """``device=None`` means cuda and raises where there is no card; a plan
    on the CPU refuses a tensor from elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: device=None is served")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    plan = make(device="cpu")
    assert plan.device == torch.device("cpu")
    with pytest.raises(ValueError):
        make(device="meta")
