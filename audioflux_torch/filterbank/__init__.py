from audioflux_torch.filterbank.scales import (
    hz_to_mel, mel_to_hz, hz_to_bark, bark_to_hz, hz_to_erb, erb_to_hz,
    hz_to_midi, midi_to_hz, hz_to_log, log_to_hz,
)
from audioflux_torch.filterbank.auditory import auditory_filter_bank
