from audioflux_torch.utils.convert import (
    power_to_db, power_to_abs_db, mag_to_abs_db,
    log_compress, log10_compress, delta, get_phase,
    note_to_midi, midi_to_note, note_to_hz, midi_to_hz, hz_to_midi,
    hz_to_note, sample_path, temproal_db,
)
from audioflux_torch.utils.scale import (
    min_max_scale, standard_scale, stand_scale, max_abs_scale,
    robust_scale, center_scale, mean_scale, arctan_scale,
)
from audioflux_torch.utils.weight import weight_a, weight_b, weight_c, weight_d

# reference wrapper names for the A/B/C/D weighting curves
auditory_weight_a = weight_a
auditory_weight_b = weight_b
auditory_weight_c = weight_c
auditory_weight_d = weight_d

from audioflux_torch.utils.util import (
    check_audio, check_audio_length, format_channel, revoke_channel,
    synth_f0, ascontiguous_T, ascontiguous_swapaxex,
)
from audioflux_torch.utils.queue import queue_fre2, queue_fre3
