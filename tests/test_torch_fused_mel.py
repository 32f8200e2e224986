"""The port's fused mel+MFCC (the CUDA kernel's plain version, run on the
CPU) against the JAX package's Pallas ``fused_mel_mfcc`` in interpret mode,
at the tolerances of tests/test_pallas_spectrogram.py; plus the same input
rejections as the JAX entry."""

import numpy as np
import pytest
import torch

from audioflux_tpu.ops.pallas_spectrogram import (FusedMelPlan as JPlan,
                                                  fused_mel_mfcc as j_fused)
from audioflux_tpu.transforms.spectrogram import MelSpectrogram as JMel
from audioflux_tpu.types import SpectralDataType, WindowType
from audioflux_torch.ops.fused_mel import (FusedMelPlan, _launch_shape,
                                           fused_mel_mfcc, fused_mel_mfcc_ref)
from audioflux_torch.transforms.spectrogram import MelSpectrogram


def _assert_close(got, ref, tol, label=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, label
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref)), label


def _both(jplan, cc_num, slide):
    """JAX plan + the port's FusedMelPlan from the same constants."""
    fp_j = JPlan(jplan.window, jplan.filter_bank, jplan._dct[:cc_num], slide)
    fp_t = FusedMelPlan(jplan.window, jplan.filter_bank, jplan._dct[:cc_num],
                        slide, device="cpu")
    return fp_j, fp_t


@pytest.mark.parametrize("fast", [False, True])
def test_fused_matches_pallas(fast):
    jplan = JMel(num=128, samplate=32000, radix2_exp=11, slide_length=512)
    T = 16
    x = (np.random.default_rng(0).standard_normal((2, T * 512 + 1536)) * 0.2
         ).astype(np.float32)
    fp_j, fp_t = _both(jplan, 13, 512)
    mel_j, cc_j = j_fused(fp_j, x, tile=8, interpret=True, fast=fast)
    mel_t, cc_t = fused_mel_mfcc(fp_t, x, fast=fast)
    tol = 2e-4 if fast else 1e-5
    _assert_close(mel_t, mel_j, tol, "mel")
    _assert_close(cc_t, cc_j, tol, "cc")


_FUZZ = [
    (9, 128, "HANN", 32, 5, 1),
    (10, 256, "HAMM", 64, 13, 2),
    (10, 512, "BLACKMAN", 48, 7, 1),
    (11, 1024, "HANN", 128, 13, 1),
    (12, 1024, "BLACKMAN_HARRIS", 96, 13, 1),
    (11, 2048, "RECT", 64, 5, 2),
]


@pytest.mark.parametrize("r2e,slide,wt,num,cc,b", _FUZZ,
                         ids=lambda v: str(v))
def test_fused_config_grid(r2e, slide, wt, num, cc, b):
    """The fuzz grid of test_pallas_spectrogram.py, against whichever
    Pallas variant 'auto' picks for each config."""
    jplan = JMel(num=num, samplate=32000, radix2_exp=r2e, slide_length=slide,
                 window_type=WindowType[wt])
    n = 16 * slide + (1 << r2e) - slide
    x = (np.random.default_rng(11 + r2e).standard_normal((b, n)) * 0.2
         ).astype(np.float32)
    fp_j, fp_t = _both(jplan, cc, slide)
    mel_j, cc_j = j_fused(fp_j, x, tile=8, interpret=True)
    mel_t, cc_t = fused_mel_mfcc(fp_t, x)
    _assert_close(mel_t, mel_j, 2e-4, "mel")
    _assert_close(cc_t, cc_j, 2e-4, "cc")


def test_fused_1d_and_odd_frames():
    """1-D input is squeezed as in the JAX entry; any frame count works."""
    jplan = JMel(num=32, samplate=32000, radix2_exp=11, slide_length=512)
    x = (np.random.default_rng(4).standard_normal(10 * 512 + 1536) * 0.1
         ).astype(np.float32)
    fp_j, fp_t = _both(jplan, 13, 512)
    mel_j, cc_j = j_fused(fp_j, x, tile=8, interpret=True)
    mel_t, cc_t = fused_mel_mfcc(fp_t, x)
    assert mel_t.shape == (32, 10) and cc_t.shape == (13, 10)
    _assert_close(mel_t, mel_j, 1e-5, "mel")
    _assert_close(cc_t, cc_j, 1e-5, "cc")


@pytest.mark.parametrize("layout", ["1-D view at offset 1", "odd length"])
def test_fused_unaligned_inputs(layout):
    """Clips that do not start on a 16-byte boundary (on the card the
    kernel then takes scalar loads): a 1-D view at a storage offset, and
    a batch of odd-length clips, against the JAX entry."""
    jplan = JMel(num=32, samplate=32000, radix2_exp=11, slide_length=512)
    fp_j, fp_t = _both(jplan, 13, 512)
    n = 11 * 512 + 1536 + 1
    base = torch.from_numpy((np.random.default_rng(8).standard_normal(
        2 * n) * 0.2).astype(np.float32))
    x = base[1:n] if layout.startswith("1-D") else base.reshape(2, n)
    assert x.is_contiguous()
    mel_j, cc_j = j_fused(fp_j, x.numpy(), tile=8, interpret=True)
    mel_t, cc_t = fused_mel_mfcc(fp_t, x)
    _assert_close(mel_t, mel_j, 1e-5, "mel")
    _assert_close(cc_t, cc_j, 1e-5, "cc")


def test_fused_leading_dims_and_ref():
    """(..., n) batches; the wrapper's CPU route is its plain version."""
    jplan = JMel(num=64, samplate=32000, radix2_exp=11, slide_length=512)
    _, fp_t = _both(jplan, 5, 512)
    x = torch.from_numpy((np.random.default_rng(6).standard_normal(
        (2, 3, 9 * 512 + 1536)) * 0.2).astype(np.float32))
    mel, cc = fused_mel_mfcc(fp_t, x)
    assert mel.shape == (2, 3, 64, 9) and cc.shape == (2, 3, 5, 9)
    mel_r, cc_r = fused_mel_mfcc_ref(fp_t, x.reshape(6, -1))
    assert torch.equal(mel.reshape(6, 64, 9), mel_r)
    assert torch.equal(cc.reshape(6, 5, 9), cc_r)


def test_fused_rejects_bad_config():
    """The JAX entry's rejections: a non-POWER plan, 128 | slide and
    slide | fft (FusedMelPlan), and a too-short signal."""
    for cls, dev in ((JMel, {}), (MelSpectrogram, {"device": "cpu"})):
        plan = cls(num=32, samplate=32000, radix2_exp=11, slide_length=512,
                   data_type=SpectralDataType.MAG, **dev)
        with pytest.raises(ValueError):
            plan.spectrogram_mfcc_fused(np.zeros(4096, np.float32))
    jplan = JMel(num=32, samplate=32000, radix2_exp=11, slide_length=512)
    for slide in (192, 384, 1536):
        with pytest.raises(AssertionError):
            JPlan(jplan.window, jplan.filter_bank, jplan._dct[:5], slide)
        with pytest.raises(ValueError):
            FusedMelPlan(jplan.window, jplan.filter_bank, jplan._dct[:5],
                         slide, device="cpu")
    _, fp_t = _both(jplan, 5, 512)
    with pytest.raises(ValueError):
        fused_mel_mfcc(fp_t, np.zeros(2000, np.float32))


def test_band_ranges_cover_the_bank():
    """The kernel's banded filterbank reproduces the dense bank exactly."""
    jplan = JMel(num=128, samplate=32000, radix2_exp=11, slide_length=512)
    _, fp = _both(jplan, 13, 512)
    dense = np.zeros_like(jplan.filter_bank)
    lo, ln, off = (fp.band_lo.numpy(), fp.band_len.numpy(),
                   fp.band_off.numpy())
    w = fp.band_w.numpy()
    for m in range(128):
        dense[m, lo[m]:lo[m] + ln[m]] = w[off[m]:off[m] + ln[m]]
    assert np.array_equal(dense, jplan.filter_bank)
    assert fp.band_nnz == ln.sum() < jplan.filter_bank.size // 4


def test_launch_shape_fits_shared_memory():
    head = _launch_shape(2048, 128, 512)
    assert (head["registers"], head["threads"], head["tile"]) == (True, 256, 16)
    for n_fft, num, slide in ((128, 32, 128), (512, 32, 128), (4096, 96, 1024),
                              (16384, 128, 4096), (16384, 128, 16384),
                              (8192, 4097, 2048), (2048, 128, 512),
                              (1024, 64, 256), (2048, 64, 2048)):
        shape = _launch_shape(n_fft, num, slide)
        assert shape["smem"] <= 227 * 1024 and shape["threads"] <= 1024
        tile = shape["tile"]
        if shape["registers"]:
            # the register-resident kernel: groups of 16, 32 or 64 threads own
            # a frame pair, a filterbank thread takes four frames
            assert n_fft in (512, 1024, 2048, 4096)
            assert tile == 2 * shape["threads"] // shape["group"] >= 4
            assert shape["threads"] % 32 == 0 and shape["threads"] <= 256
            continue
        np_, staged = shape["np"], shape["staged"]
        assert tile % 2 == 0 and (tile // 2) % np_ == 0
        assert np_ * n_fft // 16 <= 1024
        stride = n_fft + n_fft // 16 + 4
        span = (tile * slide + n_fft - slide) if staged else 0
        assert 8 * stride * np_ + 4 * (2 * tile * num + span) <= 227 * 1024
    assert _launch_shape(16384, 128, 16384)["staged"] == 0  # span too large
    with pytest.raises(ValueError):
        _launch_shape(16384, 8193, 4096)


def test_launch_rejects_timing_cuts_outside_the_register_kernel():
    """``stages`` < 4 exists in the register-resident kernel only, and the
    planner and the entry point took no new parameter."""
    import inspect

    from audioflux_torch.ops import fused_mel
    jplan = JMel(num=24, samplate=32000, radix2_exp=7, slide_length=128)
    _, fp = _both(jplan, 5, 128)
    assert not _launch_shape(128, 24, 128)["registers"]
    with pytest.raises(ValueError, match="timing cuts"):
        fused_mel._launch(fp, torch.zeros((1, 256)), 2, stages=2)
    assert list(inspect.signature(_launch_shape).parameters) == [
        "n_fft", "num", "slide"]
    assert list(inspect.signature(fused_mel_mfcc).parameters) == [
        "plan", "x", "fast"]
