"""audioflux_torch — the PyTorch/CUDA port of audioflux_tpu.

It carries the filterbank spectrograms (mel/bark/erb/linear/octave/
chroma) with their spectral-feature surface, the cepstral family, the
fused mel+MFCC throughput path, BFT (with reassignment and the fused
path), temporal features, STFT/ISTFT (also streaming), CQT/VQT with the
polyphase resampler, the spectral features, deconvolution, onset
detection, HPSS, YIN pitch and the wavelet family (CWT, PWT,
synchrosqueezing, WSST), the remaining transforms (ST, FST, NSGT,
DWT/WPT/SWT, Cepstrogram, Deep/DeepChroma) behind ``FeatureExtractor``,
and the DSP one-shots (CZT, xcorr, Hilbert, DCT, convolution, phase
vocoder, FIR design), the pitch engines (NCF, CEP, HPS, LHS, PEF, STFT,
FFP), harmonic counting and harmonic ratio, the tuner ``TuneTrack``, time
stretch and pitch shift, and the classic family (NMF, HMM, Viterbi, and
``HPSSNMF`` built on NMF), with hand-written Hopper (sm_90a) kernels
for the fused pipeline (``ops.fused_mel``), the pow2 FFT forward, inverse
and fused autocorrelation (``ops.cuda_fft``), the sliding median
(``ops.cuda_median``), the wavelet filterbank convolution
(``ops.cuda_cwt``), the phase unwrap + difference (``ops.cuda_unwrap``)
and the reassignment scatter (``ops.cuda_scatter``); and the rest of the
surface: WAV I/O (``io.wave``, the native loader ``io.native``), the
parallel family (``parallel``: a device mesh, halo-sharded mel and STFT,
band-sharded wavelet and full-signal transforms, a pipeline, a batch
runner, multi-process start-up), ``observe``, ``utils``, ``fftlib`` and
``display``.

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
    WaveletContinueType,
    WaveletDiscreteType,
    ReassignType,
    NoveltyType,
    PitchType,
    ResampleQualityType,
    SpectralNoveltyMethodType,
    SpectralNoveltyDataType,
)
from audioflux_torch.transforms.spectrogram import (
    Spectrogram, MelSpectrogram, BarkSpectrogram, ErbSpectrogram,
)
from audioflux_torch.transforms.stft import (
    STFT, StreamingSTFT, stft, istft,
)
from audioflux_torch.transforms.cwt import CWT, cwt_filter_bank
from audioflux_torch.transforms.pwt import PWT
from audioflux_torch.transforms.synsq import Synsq
from audioflux_torch.transforms.wsst import WSST
from audioflux_torch.transforms.temporal import Temporal
from audioflux_torch.transforms.reassign import Reassign, reassign_windows
from audioflux_torch.transforms.bft import BFT
from audioflux_torch.transforms.cqt import (
    CQT, VQT, SimpleCQT, cqt_filter_bank, chroma_cqt_filter_bank,
)
from audioflux_torch.transforms.deep import (
    DeepSpectrogram, DeepChromaSpectrogram,
)
from audioflux_torch.transforms.nsgt import NSGT, NSGTFilterBankType
from audioflux_torch.transforms.st import ST
from audioflux_torch.transforms.fst import FST
from audioflux_torch.transforms.dwt import DWT, WPT, SWT
from audioflux_torch.transforms.cepstrogram import Cepstrogram
from audioflux_torch.dsp import (
    Resample, WindowResample, resample, CZT, czt, Xcorr, XcorrNormalType,
    xcorr, Hilbert, hilbert, DCT, dct, idct, phase_vocoder,
)
from audioflux_torch.features.xxcc import XXCC
from audioflux_torch.features.spectral import Spectral
from audioflux_torch.features.deconv import Deconv
from audioflux_torch.features.extractor import FeatureExtractor, FeatureResult
from audioflux_torch.mir import (
    HPSS, HPSSNMF, PitchYIN, Onset, NoveltyParam, peak_pick,
    PitchNCF, PitchCEP, PitchHPS, PitchLHS, PitchPEF, PitchSTFT, PitchFFP,
    Harmonic, HarmonicRatio, TimeStretch, PitchShift,
)
from audioflux_torch.track import TuneTrack
from audioflux_torch.classic import NMF, HMM, nmf, viterbi
from audioflux_torch.core import (
    linear_spectrogram, mel_spectrogram, bark_spectrogram, erb_spectrogram,
    mfcc, bfcc, gtcc, cqt, vqt, cqcc, chroma_linear, chroma_octave,
    chroma_cqt,
)
from audioflux_torch.convert import load_reference_constants
from audioflux_torch.io.wave import (
    read, write, WaveReader, WaveWriter, chirp, convert_mono,
)
from audioflux_torch import utils
from audioflux_torch import parallel
from audioflux_torch import display
from audioflux_torch import observe

__version__ = "0.1.0"
