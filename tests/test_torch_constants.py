"""The port's host constant builders and enums against the JAX package's:
windows, frequency scales, auditory/chroma filterbanks and the DCT must be
array-equal, enums identical in names and values."""

import inspect

import numpy as np
import pytest

import audioflux_torch.filterbank.auditory as t_aud
import audioflux_torch.filterbank.chroma as t_chroma
import audioflux_torch.filterbank.scales as t_scales
import audioflux_torch.ops.window as t_window
import audioflux_torch.transforms.spectrogram as t_spec
import audioflux_torch.types as t_types
import audioflux_torch.utils.convert as t_convert
import audioflux_tpu.filterbank.auditory as j_aud
import audioflux_tpu.filterbank.chroma as j_chroma
import audioflux_tpu.filterbank.scales as j_scales
import audioflux_tpu.ops.window as j_window
import audioflux_tpu.transforms.spectrogram as j_spec
import audioflux_tpu.types as j_types
import audioflux_tpu.utils.convert as j_convert

S = j_types.SpectralFilterBankScaleType
ST = j_types.SpectralFilterBankStyleType
NT = j_types.SpectralFilterBankNormalType


def _enums(mod):
    return {name: obj for name, obj in vars(mod).items()
            if inspect.isclass(obj) and issubclass(obj, j_types.IntEnum)
            and obj is not j_types.IntEnum}


def test_enums_identical():
    j, t = _enums(j_types), _enums(t_types)
    assert sorted(j) == sorted(t)
    for name in j:
        assert ([(m.name, m.value) for m in j[name]]
                == [(m.name, m.value) for m in t[name]]), name
    import audioflux_torch.type as t_type
    assert t_type.WindowType is t_types.WindowType


@pytest.mark.parametrize("wt", list(j_types.WindowType), ids=lambda w: w.name)
def test_windows_equal(wt):
    for n in (7, 64, 2048, 4096):
        assert np.array_equal(t_window.get_window(t_types.WindowType(wt), n),
                              j_window.get_window(wt, n)), n
        assert np.array_equal(
            t_window.get_fft_window(t_types.WindowType(wt), n),
            j_window.get_fft_window(wt, n)), n


def test_scales_equal():
    f = np.linspace(0.0, 16000.0, 257, dtype=np.float32)[1:]
    for name in t_scales.__all__:
        fn_t, fn_j = getattr(t_scales, name), getattr(j_scales, name)
        if name.startswith("hz_to"):
            arg = f
        else:  # x_to_hz takes values on scale x
            arg = getattr(j_scales, "hz_to_" + name[:-len("_to_hz")])(f)
        assert np.array_equal(fn_t(arg), fn_j(arg)), name


def test_note_conversions_equal():
    for note in ("C1", "A4", "C#3", "Bb2", "G-1"):
        assert t_convert.note_to_hz(note) == j_convert.note_to_hz(note)
        assert t_convert.note_to_midi(note) == j_convert.note_to_midi(note)
    f = np.array([27.5, 440.0, 1000.0])
    assert np.array_equal(t_convert.hz_to_midi(f), j_convert.hz_to_midi(f))
    assert np.array_equal(t_convert.midi_to_hz(f), j_convert.midi_to_hz(f))


def _outcome(fn, *args, **kw):
    """fn's result, or the type of the exception it raised."""
    try:
        return fn(*args, **kw)
    except (IndexError, ValueError) as e:
        return type(e)


_AUD_SCALES = [S.LINEAR, S.LINSPACE, S.MEL, S.BARK, S.ERB, S.OCTAVE, S.LOG,
               S.LOG_CHROMA]


@pytest.mark.parametrize("scale", _AUD_SCALES, ids=lambda s: s.name)
def test_auditory_filter_bank_equal(scale):
    """Every style and normalization of each scale the builder takes."""
    log_like = scale in (S.OCTAVE, S.LOG, S.LOG_CHROMA)
    low, high = (32.703196, 8000.0) if log_like else (0.0, 16000.0)
    num = 24
    for style in ST:
        for norm in NT:
            args = (num, 512, 32000)
            kw = dict(low_fre=low, high_fre=high, bin_per_octave=12)
            got = _outcome(
                t_aud.auditory_filter_bank, *args,
                t_types.SpectralFilterBankScaleType(scale),
                t_types.SpectralFilterBankStyleType(style),
                t_types.SpectralFilterBankNormalType(norm), **kw)
            ref = _outcome(j_aud.auditory_filter_bank, *args, scale, style,
                           norm, **kw)
            if isinstance(ref, type):  # the reference refuses this combination
                assert got is ref, (style.name, norm.name)
                continue
            for a, b in zip(got, ref):
                assert np.array_equal(a, b), (style.name, norm.name)


def test_main_path_banks_equal():
    """The main path's 128-band mel bank at n_fft 2048, plus bark/erb."""
    for scale in (S.MEL, S.BARK, S.ERB):
        got = t_aud.auditory_filter_bank(
            128, 2048, 32000, t_types.SpectralFilterBankScaleType(scale),
            t_types.SpectralFilterBankStyleType.SLANEY,
            t_types.SpectralFilterBankNormalType.NONE, 0.0, 16000.0, 12)
        ref = j_aud.auditory_filter_bank(128, 2048, 32000, scale, ST.SLANEY,
                                         NT.NONE, 0.0, 16000.0, 12)
        for a, b in zip(got, ref):
            assert np.array_equal(a, b), scale.name


def test_chroma_banks_equal():
    for num in (12, 24):
        assert np.array_equal(t_chroma.chroma_stft_filter_bank(num, 2048, 32000),
                              j_chroma.chroma_stft_filter_bank(num, 2048, 32000))
    for num, band, bpo, fmin in ((12, 84, 12, 32.703196), (12, 100, 24, 55.0),
                                 (6, 60, 12, 32.703196)):
        assert np.array_equal(
            t_chroma.chroma_fold_filter_bank(num, band, bpo, fmin),
            j_chroma.chroma_fold_filter_bank(num, band, bpo, fmin))


def test_dct_matrix_equal():
    for n in (2, 13, 64, 128):
        assert np.array_equal(t_spec.dct_matrix(n), j_spec.dct_matrix(n))
