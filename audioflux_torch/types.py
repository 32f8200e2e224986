"""Enum types mirroring the reference's parameter surface.

Semantics follow the reference C enums in ``src/flux_base.h:14-187`` (values are
kept identical so configs translate 1:1); only the spelling is Pythonic.
"""

from enum import IntEnum


class WindowType(IntEnum):
    RECT = 0
    HANN = 1
    HAMM = 2
    BLACKMAN = 3
    KAISER = 4
    BARTLETT = 5
    TRIANG = 6
    FLATTOP = 7
    GAUSS = 8
    BLACKMAN_HARRIS = 9
    BLACKMAN_NUTTALL = 10
    BARTLETT_HANN = 11
    BOHMAN = 12
    TUKEY = 13


class SpectralDataType(IntEnum):
    POWER = 0
    MAG = 1


class SpectralFilterBankScaleType(IntEnum):
    LINEAR = 0
    LINSPACE = 1
    MEL = 2
    BARK = 3
    ERB = 4
    OCTAVE = 5
    LOG = 6
    DEEP = 7
    CHROMA = 8
    LOG_CHROMA = 9
    DEEP_CHROMA = 10


# Alias matching the reference Python layer naming (SpectralFilterBankType)
SpectralFilterBankType = SpectralFilterBankScaleType


class SpectralFilterBankStyleType(IntEnum):
    SLANEY = 0
    ETSI = 1
    GAMMATONE = 2
    POINT = 3
    RECT = 4
    HANN = 5
    HAMM = 6
    BLACKMAN = 7
    BOHMAN = 8
    KAISER = 9
    GAUSS = 10


class SpectralFilterBankNormalType(IntEnum):
    NONE = 0
    AREA = 1
    BAND_WIDTH = 2


class SpectralNoveltyMethodType(IntEnum):
    SUB = 0
    ENTROY = 1  # (sic) name kept for parity with the reference
    KL = 2
    IS = 3


class SpectralNoveltyDataType(IntEnum):
    VALUE = 0
    NUMBER = 1


class ChromaDataNormalType(IntEnum):
    NONE = 0
    MAX = 1
    MIN = 2
    P2 = 3
    P1 = 4


class CepstralRectifyType(IntEnum):
    LOG = 0
    CUBIC_ROOT = 1


class CepstralEnergyType(IntEnum):
    REPLACE = 0
    APPEND = 1
    IGNORE = 2


class PaddingPositionType(IntEnum):
    CENTER = 0
    RIGHT = 1
    LEFT = 2


class PaddingModeType(IntEnum):
    CONSTANT = 0
    REFLECT = 1
    WRAP = 2


class WaveletContinueType(IntEnum):
    MORSE = 0
    MORLET = 1
    BUMP = 2
    PAUL = 3
    DOG = 4
    MEXICAN = 5
    HERMIT = 6
    RICKER = 7


class WaveletDiscreteType(IntEnum):
    HAAR = 0
    DB = 1
    SYM = 2
    COIF = 3
    FK = 4
    BIOR = 5
    DMEY = 6


class PitchType(IntEnum):
    YIN = 0
    STFT = 1
    NCF = 2
    PEF = 3
    CEP = 4
    HPS = 5
    LHS = 6
    FFP = 7


class NoveltyType(IntEnum):
    """Onset novelty function types (reference ``onset_algorithm.h:11-28``)."""
    FLUX = 0
    HFC = 1
    SD = 2
    SF = 3
    MKL = 4
    PD = 5
    WPD = 6
    NWPD = 7
    CD = 8
    RCD = 9
    BROADBAND = 10


class ReassignType(IntEnum):
    """Reassignment types (reference ``reassign_algorithm.h:14-21``)."""
    ALL = 0
    FRE = 1
    TIME = 2
    NONE = 3


class SynsqFilterBankScaleType(IntEnum):
    """Target frequency-bin layout for synchrosqueezing (``synsq_algorithm.h``)."""
    LINEAR = 0
    LINSPACE = 1
    LOG = 2


class ResampleQualityType(IntEnum):
    BEST = 0
    MID = 1
    FAST = 2


def get_wavelet_default_gamma_beta(wavelet_type):
    """Default (gamma, beta) for each continuous wavelet.

    Mirrors the reference helper (``python/audioflux/type/basic.py:395-445``):
    morse (3, 20), morlet (6, 2), bump (5, 0.6), paul (4, 0), dog (2, 2),
    mexican (0, 2), hermit (5, 2), ricker (4, 0).
    """
    W = WaveletContinueType
    table = {W.MORSE: (3, 20), W.MORLET: (6, 2), W.BUMP: (5, 0.6),
             W.PAUL: (4, 0), W.DOG: (2, 2), W.MEXICAN: (0, 2),
             W.HERMIT: (5, 2), W.RICKER: (4, 0)}
    return table.get(W(wavelet_type), (0, 0))


class FilterBandType(IntEnum):
    """Declared by the reference (``type/basic.py:98``) but consumed by no
    wrapper API (the C IIR design behind it is empty); kept for import
    parity."""
    LOW_PASS = 0
    HIGH_PASS = 1
    BAND_PASS = 2
    BAND_STOP = 3


class ReduceType(IntEnum):
    """Onset flux reduction (``type/onset.py:9``)."""
    MEAN = 0
    SUM = 1
    LOG = 2


class ResampleAlgType(IntEnum):
    """Resampler algorithm family (``type/resample.py:9``)."""
    POLYPHASE = 0
    BANDLIMITED = 1
