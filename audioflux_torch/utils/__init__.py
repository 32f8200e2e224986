from audioflux_torch.utils.convert import (
    note_to_midi, midi_to_hz, hz_to_midi, note_to_hz,
)
from audioflux_torch.utils.queue import queue_fre2, queue_fre3
