from audioflux_torch.transforms.spectrogram import (
    Spectrogram, MelSpectrogram, BarkSpectrogram, ErbSpectrogram,
)
