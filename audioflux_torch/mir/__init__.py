from audioflux_torch.mir.hpss import HPSS, HPSSNMF  # noqa: F401
from audioflux_torch.mir.onset import (  # noqa: F401
    NoveltyParam, Onset, peak_pick)
from audioflux_torch.mir.pitch_yin import PitchYIN  # noqa: F401
from audioflux_torch.mir.pitch import (  # noqa: F401
    PitchNCF, PitchCEP, PitchHPS, PitchLHS, PitchPEF,
)
from audioflux_torch.mir.harmonic import Harmonic  # noqa: F401
from audioflux_torch.mir.harmonic_ratio import HarmonicRatio  # noqa: F401
from audioflux_torch.mir.time_stretch import (  # noqa: F401
    TimeStretch, PitchShift)
from audioflux_torch.mir.pitch_stft import PitchSTFT  # noqa: F401
from audioflux_torch.mir.pitch_ffp import PitchFFP  # noqa: F401
