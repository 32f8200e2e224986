from audioflux_torch.utils.convert import (
    note_to_midi, midi_to_hz, hz_to_midi, note_to_hz,
)
