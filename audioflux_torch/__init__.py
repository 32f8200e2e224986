"""audioflux_torch — the PyTorch/CUDA port of audioflux_tpu.

This slice carries the filterbank spectrograms (mel/bark/erb/linear/
octave/chroma), the cepstral family and the fused mel+MFCC throughput
path, with hand-written Hopper (sm_90a) kernels for the fused pipeline
(``ops.fused_mel``) and the pow2 FFT (``ops.cuda_fft``).

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
)
from audioflux_torch.transforms.spectrogram import (
    Spectrogram, MelSpectrogram, BarkSpectrogram, ErbSpectrogram,
)
from audioflux_torch.features.xxcc import XXCC
from audioflux_torch.core import (
    mel_spectrogram, bark_spectrogram, erb_spectrogram,
)
from audioflux_torch.convert import load_reference_constants

__version__ = "0.1.0"
