"""One-shot functional API.

Mirrors ``python/audioflux/core.py:17-1358`` as the TPU package's
``core.py`` does: convenience wrappers that build the matching plan
object (memoized), run it and return its outputs, with the reference
one-shots' own quirks (``cqt``/``vqt`` return |C|, ``cqcc`` feeds |C|^2,
``chroma_cqt`` squares the complex matrix, the cepstral one-shots run BFT
with an AREA-normalized POWER bank).  Each takes ``device`` (``None``
means ``cuda``).
"""

from __future__ import annotations

import functools

from audioflux_torch.features.xxcc import XXCC
from audioflux_torch.ops.backend import resolve_device
from audioflux_torch.transforms.bft import BFT
from audioflux_torch.transforms.cqt import CQT, VQT
from audioflux_torch.transforms.spectrogram import (BarkSpectrogram,
                                                    ErbSpectrogram,
                                                    MelSpectrogram,
                                                    Spectrogram)
from audioflux_torch.types import (CepstralRectifyType, ChromaDataNormalType,
                                   SpectralDataType,
                                   SpectralFilterBankNormalType,
                                   SpectralFilterBankScaleType,
                                   SpectralFilterBankStyleType, WindowType)
from audioflux_torch.utils.convert import note_to_hz

__all__ = [
    "linear_spectrogram", "mel_spectrogram", "bark_spectrogram",
    "erb_spectrogram", "mfcc", "bfcc", "gtcc", "cqcc", "cqt", "vqt",
    "chroma_linear", "chroma_octave", "chroma_cqt",
]


@functools.lru_cache(maxsize=256)
def _plan_cache(cls, items, chroma_norm=None):
    obj = cls(**dict(items))
    if chroma_norm is not None:
        obj.set_chroma_data_normal_type(chroma_norm)
    return obj


def _plan(cls, _chroma_norm=None, **kwargs):
    """Memoized plan constructor: identical one-shot calls reuse one plan
    and so its device constants (the filterbank upload is the costly part
    of a small call).  Every argument is a hashable scalar, enum or
    ``torch.device``."""
    return _plan_cache(cls, tuple(sorted(kwargs.items())), _chroma_norm)


def linear_spectrogram(X, num=None, radix2_exp=12, samplate=32000,
                       slide_length=None, low_fre=0.0,
                       window_type=WindowType.HANN,
                       style_type=SpectralFilterBankStyleType.SLANEY,
                       data_type=SpectralDataType.POWER,
                       is_reassign=False, device=None):
    """Linear/STFT spectrogram via BFT, like the reference one-shot
    (core.py:17-141: result_type 1, num defaulting to fft//2+1)."""
    if num is None:
        num = (1 << radix2_exp) // 2 + 1
    obj = _plan(BFT, num=num, radix2_exp=radix2_exp, samplate=samplate,
                low_fre=low_fre, window_type=window_type,
                slide_length=slide_length,
                scale_type=SpectralFilterBankScaleType.LINEAR,
                style_type=style_type, data_type=data_type,
                is_reassign=is_reassign, device=resolve_device(device))
    return obj.bft(X, result_type=1), obj.get_fre_band_arr()


def _band_spectrogram(cls, X, num, radix2_exp, samplate, slide_length,
                      low_fre, high_fre, window_type, data_type, style_type,
                      normal_type, device):
    obj = _plan(cls, num=num, samplate=samplate, radix2_exp=radix2_exp,
                slide_length=slide_length, low_fre=low_fre, high_fre=high_fre,
                window_type=window_type, data_type=data_type,
                style_type=style_type, normal_type=normal_type,
                device=resolve_device(device))
    return obj.spectrogram(X), obj.get_fre_band_arr()


def mel_spectrogram(X, num=128, radix2_exp=12, samplate=32000,
                    slide_length=None, low_fre=0.0, high_fre=None,
                    window_type=WindowType.HANN,
                    data_type=SpectralDataType.POWER,
                    style_type=SpectralFilterBankStyleType.SLANEY,
                    normal_type=SpectralFilterBankNormalType.NONE,
                    device=None):
    return _band_spectrogram(
        MelSpectrogram, X, num, radix2_exp, samplate, slide_length, low_fre,
        high_fre, window_type, data_type, style_type, normal_type, device)


def bark_spectrogram(X, num=128, radix2_exp=12, samplate=32000,
                     slide_length=None, low_fre=0.0, high_fre=None,
                     window_type=WindowType.HANN,
                     data_type=SpectralDataType.POWER,
                     style_type=SpectralFilterBankStyleType.SLANEY,
                     normal_type=SpectralFilterBankNormalType.NONE,
                     device=None):
    return _band_spectrogram(
        BarkSpectrogram, X, num, radix2_exp, samplate, slide_length, low_fre,
        high_fre, window_type, data_type, style_type, normal_type, device)


def erb_spectrogram(X, num=128, radix2_exp=12, samplate=32000,
                    slide_length=None, low_fre=0.0, high_fre=None,
                    window_type=WindowType.HANN,
                    data_type=SpectralDataType.POWER,
                    style_type=SpectralFilterBankStyleType.SLANEY,
                    normal_type=SpectralFilterBankNormalType.NONE,
                    device=None):
    return _band_spectrogram(
        ErbSpectrogram, X, num, radix2_exp, samplate, slide_length, low_fre,
        high_fre, window_type, data_type, style_type, normal_type, device)


def _bft_cc(scale_type, style_type, X, num, cc_num, rectify_type,
            radix2_exp, samplate, slide_length, low_fre, high_fre,
            window_type, device):
    """The reference cc one-shots (core.py:600-830) run BFT with an
    AREA-normalized POWER bank, take |complex result| and feed XXCC, not
    the xx_spectrogram + xxcc composition of the classes."""
    dev = resolve_device(device)
    obj = _plan(BFT, num=num, radix2_exp=radix2_exp, samplate=samplate,
                low_fre=low_fre, high_fre=high_fre,
                window_type=window_type, slide_length=slide_length,
                scale_type=scale_type, style_type=style_type,
                normal_type=SpectralFilterBankNormalType.AREA,
                data_type=SpectralDataType.POWER, device=dev)
    spec = obj.bft(X, result_type=0).abs()
    cc = _plan(XXCC, num=obj.num, device=dev).xxcc(spec, cc_num,
                                                   rectify_type)
    return cc, obj.get_fre_band_arr()


def mfcc(X, cc_num=13, rectify_type=CepstralRectifyType.LOG, mel_num=128,
         radix2_exp=12, samplate=32000, slide_length=None,
         low_fre=None, high_fre=None, window_type=WindowType.HANN,
         device=None):
    return _bft_cc(SpectralFilterBankScaleType.MEL,
                   SpectralFilterBankStyleType.SLANEY, X, mel_num, cc_num,
                   rectify_type, radix2_exp, samplate, slide_length,
                   low_fre, high_fre, window_type, device)


def bfcc(X, cc_num=13, rectify_type=CepstralRectifyType.LOG, bark_num=128,
         radix2_exp=12, samplate=32000, slide_length=None,
         low_fre=None, high_fre=None, window_type=WindowType.HANN,
         device=None):
    return _bft_cc(SpectralFilterBankScaleType.BARK,
                   SpectralFilterBankStyleType.SLANEY, X, bark_num, cc_num,
                   rectify_type, radix2_exp, samplate, slide_length,
                   low_fre, high_fre, window_type, device)


def gtcc(X, cc_num=13, rectify_type=CepstralRectifyType.LOG, erb_num=128,
         radix2_exp=12, samplate=32000, slide_length=None,
         low_fre=None, high_fre=None, window_type=WindowType.HANN,
         device=None):
    return _bft_cc(SpectralFilterBankScaleType.ERB,
                   SpectralFilterBankStyleType.GAMMATONE, X, erb_num,
                   cc_num, rectify_type, radix2_exp, samplate, slide_length,
                   low_fre, high_fre, window_type, device)


def cqt(X, num=84, samplate=32000, low_fre=None, bin_per_octave=12,
        factor=1.0, thresh=0.01, window_type=WindowType.HANN,
        slide_length=None,
        normal_type=SpectralFilterBankNormalType.AREA, is_scale=True,
        device=None):
    """|CQT| (the reference one-shot returns the magnitude, core.py:1040;
    use the CQT class for the complex matrix) and the band frequencies."""
    obj = _plan(CQT, device=resolve_device(device), num=num,
                samplate=samplate, low_fre=low_fre,
                bin_per_octave=bin_per_octave,
                factor=factor, thresh=thresh, window_type=window_type,
                slide_length=slide_length, normal_type=normal_type,
                is_scale=is_scale)
    return obj.cqt(X).abs(), obj.get_fre_band_arr()


def vqt(X, num=84, samplate=32000, low_fre=None, bin_per_octave=12,
        factor=1.0, beta=0.5, thresh=0.01, window_type=WindowType.HANN,
        slide_length=None,
        normal_type=SpectralFilterBankNormalType.AREA, is_scale=True,
        device=None):
    obj = _plan(VQT, device=resolve_device(device), num=num,
                samplate=samplate, low_fre=low_fre,
                bin_per_octave=bin_per_octave,
                factor=factor, beta=beta, thresh=thresh,
                window_type=window_type, slide_length=slide_length,
                normal_type=normal_type, is_scale=is_scale)
    return obj.cqt(X).abs(), obj.get_fre_band_arr()


def cqcc(X, cc_num=13, rectify_type=CepstralRectifyType.LOG, cqt_num=84,
         samplate=32000, low_fre=None, slide_length=None,
         bin_per_octave=12, window_type=WindowType.HANN,
         normal_type=SpectralFilterBankNormalType.AREA, is_scale=True,
         factor=1.0, thresh=0.01, device=None):
    """The reference one-shot feeds |C|^2 (POWER) to cqtObj_cqcc
    (core.py:929), unlike the class-level use with the magnitude."""
    obj = _plan(CQT, device=resolve_device(device), num=cqt_num,
                samplate=samplate, low_fre=low_fre,
                bin_per_octave=bin_per_octave,
                factor=factor, thresh=thresh, window_type=window_type,
                slide_length=slide_length, normal_type=normal_type,
                is_scale=is_scale)
    power = obj.cqt(X).abs().square()
    return obj.cqcc(power, cc_num, rectify_type), obj.get_fre_band_arr()


def chroma_linear(X, chroma_num=12, radix2_exp=12, samplate=32000,
                  low_fre=0.0, high_fre=16000.0, slide_length=None,
                  window_type=WindowType.HANN,
                  style_type=SpectralFilterBankStyleType.SLANEY,
                  data_type=SpectralDataType.POWER,
                  normal_type=SpectralFilterBankNormalType.NONE,
                  norm_type=ChromaDataNormalType.MAX, device=None):
    obj = _plan(Spectrogram, _chroma_norm=norm_type, num=chroma_num,
                samplate=samplate, radix2_exp=radix2_exp,
                slide_length=slide_length, low_fre=low_fre,
                high_fre=high_fre, window_type=window_type,
                style_type=style_type, normal_type=normal_type,
                data_type=data_type,
                filter_bank_type=SpectralFilterBankScaleType.CHROMA,
                device=resolve_device(device))
    return obj.spectrogram(X)


def chroma_octave(X, chroma_num=12, radix2_exp=12, samplate=32000,
                  low_fre=None, high_fre=16000.0, bin_per_octave=12,
                  slide_length=None, window_type=WindowType.HANN,
                  data_type=SpectralDataType.POWER,
                  style_type=SpectralFilterBankStyleType.SLANEY,
                  normal_type=SpectralFilterBankNormalType.NONE,
                  norm_type=ChromaDataNormalType.MAX, device=None):
    if low_fre is None:
        low_fre = note_to_hz("C1")
    obj = _plan(Spectrogram, _chroma_norm=norm_type, num=chroma_num,
                samplate=samplate, radix2_exp=radix2_exp,
                slide_length=slide_length, low_fre=low_fre,
                high_fre=high_fre, bin_per_octave=bin_per_octave,
                window_type=window_type, data_type=data_type,
                style_type=style_type, normal_type=normal_type,
                filter_bank_type=SpectralFilterBankScaleType.LOG_CHROMA,
                device=resolve_device(device))
    return obj.spectrogram(X)


def chroma_cqt(X, chroma_num=12, num=84, samplate=32000, low_fre=None,
               bin_per_octave=12, factor=1.0, thresh=0.01,
               window_type=WindowType.HANN, slide_length=None,
               normal_type=SpectralFilterBankNormalType.AREA, is_scale=True,
               data_type=SpectralDataType.POWER,
               norm_type=ChromaDataNormalType.MAX, device=None):
    """The reference one-shot squares the complex CQT matrix before the
    chroma fold (core.py:1457), so under POWER the fold weighs |C|^4."""
    obj = _plan(CQT, device=resolve_device(device), num=num,
                samplate=samplate, low_fre=low_fre,
                bin_per_octave=bin_per_octave,
                factor=factor, thresh=thresh, window_type=window_type,
                slide_length=slide_length, normal_type=normal_type,
                is_scale=is_scale)
    C = obj.cqt(X)
    return obj.chroma(C * C, chroma_num, data_type, norm_type)
