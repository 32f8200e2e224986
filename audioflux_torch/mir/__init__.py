from audioflux_torch.mir.hpss import HPSS  # noqa: F401
from audioflux_torch.mir.pitch_yin import PitchYIN  # noqa: F401
