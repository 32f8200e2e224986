from audioflux_torch.mir.hpss import HPSS  # noqa: F401
from audioflux_torch.mir.onset import (  # noqa: F401
    NoveltyParam, Onset, peak_pick)
from audioflux_torch.mir.pitch_yin import PitchYIN  # noqa: F401
