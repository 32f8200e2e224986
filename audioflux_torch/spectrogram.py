"""Legacy v1 preset spectrogram classes.

Counterpart of ``audioflux_tpu/spectrogram.py``.  The reference keeps a
first-generation module ``audioflux.spectrogram``
(``python/audioflux/spectrogram.py:2272-2809``) with simple preset classes
(``Linear``/``Mel``/``Bark``/``Erb``/``Chroma``/``Deep``/``DeepChroma``),
each of which calls a ``spectrogramObj_new<Scale>`` C constructor that is
just ``spectrogramObj_new`` with every optional parameter left at its C
default (``src/spectrogram_algorithm.c:186-324``).  Here each preset is the
same thing: the modern plan class with only the scale pinned, so the
actual frequency range is the C default ``[scale default low,
samplate/2]``.  Each takes ``device`` (``None`` means ``cuda``).
"""

from audioflux_torch.transforms.deep import (DeepChromaSpectrogram,
                                             DeepSpectrogram)
from audioflux_torch.transforms.spectrogram import Spectrogram
from audioflux_torch.types import SpectralFilterBankScaleType as _S

__all__ = ["Spectrogram", "Linear", "Mel", "Bark", "Erb", "Chroma",
           "Deep", "DeepChroma"]


class Linear(Spectrogram):
    """Preset linear spectrogram (``spectrogram.py:2272`` `Linear`):
    full STFT bin range, all other parameters at C defaults."""

    def __init__(self, samplate=32000, radix2_exp=12, device=None):
        super().__init__(num=0, samplate=samplate, radix2_exp=radix2_exp,
                         filter_bank_type=_S.LINEAR, device=device)


class Mel(Spectrogram):
    """Preset mel spectrogram (``spectrogram.py:2345`` `Mel`)."""

    def __init__(self, num=128, samplate=32000, radix2_exp=12, device=None):
        super().__init__(num=num, samplate=samplate, radix2_exp=radix2_exp,
                         filter_bank_type=_S.MEL, device=device)


class Bark(Spectrogram):
    """Preset bark spectrogram (``spectrogram.py:2423`` `Bark`)."""

    def __init__(self, num=128, samplate=32000, radix2_exp=12, device=None):
        super().__init__(num=num, samplate=samplate, radix2_exp=radix2_exp,
                         filter_bank_type=_S.BARK, device=device)


class Erb(Spectrogram):
    """Preset erb spectrogram (``spectrogram.py:2505`` `Erb`)."""

    def __init__(self, num=128, samplate=32000, radix2_exp=12, device=None):
        super().__init__(num=num, samplate=samplate, radix2_exp=radix2_exp,
                         filter_bank_type=_S.ERB, device=device)


class Chroma(Spectrogram):
    """Preset 12-bin chroma spectrogram (``spectrogram.py:2583`` `Chroma`)."""

    def __init__(self, samplate=32000, radix2_exp=12, device=None):
        super().__init__(num=12, samplate=samplate, radix2_exp=radix2_exp,
                         filter_bank_type=_S.CHROMA, device=device)


class Deep(DeepSpectrogram):
    """Preset deep spectrogram (``spectrogram.py:2655`` `Deep`)."""

    def __init__(self, num, samplate=32000, radix2_exp=12, device=None):
        super().__init__(num=num, samplate=samplate, radix2_exp=radix2_exp,
                         device=device)


class DeepChroma(DeepChromaSpectrogram):
    """Preset deep-chroma spectrogram (``spectrogram.py:2739``
    `DeepChroma`)."""

    def __init__(self, samplate=32000, radix2_exp=12, device=None):
        super().__init__(samplate=samplate, radix2_exp=radix2_exp,
                         device=device)
