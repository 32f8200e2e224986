"""audioflux_torch — the PyTorch/CUDA port of audioflux_tpu.

It carries the filterbank spectrograms (mel/bark/erb/linear/octave/
chroma), the cepstral family, the fused mel+MFCC throughput path,
STFT/ISTFT (also streaming), HPSS and YIN pitch, with hand-written Hopper
(sm_90a) kernels for the fused pipeline (``ops.fused_mel``), the pow2 FFT
forward, inverse and fused autocorrelation (``ops.cuda_fft``) and the
sliding median (``ops.cuda_median``).

Plans and one-shots take ``device=None``, which means ``cuda``: with no
CUDA device they raise; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels on the CPU.  The kernels are compiled with
``nvcc`` at first use into ``audioflux_torch/_build/``.
"""

from audioflux_torch.types import (
    WindowType,
    SpectralDataType,
    SpectralFilterBankScaleType,
    SpectralFilterBankStyleType,
    SpectralFilterBankNormalType,
    ChromaDataNormalType,
    CepstralRectifyType,
    CepstralEnergyType,
    PaddingPositionType,
    PaddingModeType,
)
from audioflux_torch.transforms.spectrogram import (
    Spectrogram, MelSpectrogram, BarkSpectrogram, ErbSpectrogram,
)
from audioflux_torch.transforms.stft import (
    STFT, StreamingSTFT, stft, istft,
)
from audioflux_torch.features.xxcc import XXCC
from audioflux_torch.mir import HPSS, PitchYIN
from audioflux_torch.core import (
    mel_spectrogram, bark_spectrogram, erb_spectrogram,
)
from audioflux_torch.convert import load_reference_constants

__version__ = "0.1.0"
