from audioflux_torch.transforms.spectrogram import (
    Spectrogram, MelSpectrogram, BarkSpectrogram, ErbSpectrogram,
)
from audioflux_torch.transforms.cwt import CWT, cwt_filter_bank
from audioflux_torch.transforms.pwt import PWT
from audioflux_torch.transforms.synsq import Synsq
from audioflux_torch.transforms.wsst import WSST
from audioflux_torch.transforms.temporal import Temporal
from audioflux_torch.transforms.reassign import Reassign
from audioflux_torch.transforms.bft import BFT
from audioflux_torch.transforms.cqt import CQT, VQT, SimpleCQT
from audioflux_torch.transforms.deep import (
    DeepSpectrogram, DeepChromaSpectrogram)
from audioflux_torch.transforms.nsgt import NSGT, NSGTFilterBankType
from audioflux_torch.transforms.st import ST
from audioflux_torch.transforms.fst import FST
from audioflux_torch.transforms.dwt import DWT, WPT, SWT
from audioflux_torch.transforms.cepstrogram import Cepstrogram
