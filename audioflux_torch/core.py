"""One-shot functional API (the band spectrograms).

Mirrors ``python/audioflux/core.py``: convenience wrappers that build the
matching plan object, run it, and return ``(spectrogram, fre_band_arr)``.
``linear_spectrogram``/``mfcc``/``bfcc``/``gtcc`` run through BFT in the
reference and wait for the BFT port.
"""

from __future__ import annotations

import functools

from audioflux_torch.ops.backend import resolve_device
from audioflux_torch.transforms.spectrogram import (BarkSpectrogram,
                                                    ErbSpectrogram,
                                                    MelSpectrogram)
from audioflux_torch.types import (SpectralDataType,
                                   SpectralFilterBankNormalType,
                                   SpectralFilterBankStyleType, WindowType)

__all__ = ["mel_spectrogram", "bark_spectrogram", "erb_spectrogram"]


@functools.lru_cache(maxsize=256)
def _plan_cache(cls, items):
    return cls(**dict(items))


def _plan(cls, **kwargs):
    """Memoized plan constructor: identical one-shot calls reuse one plan
    and so its device constants (the filterbank upload is the costly part
    of a small call).  Every argument is a hashable scalar, enum or
    ``torch.device``."""
    return _plan_cache(cls, tuple(sorted(kwargs.items())))


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
