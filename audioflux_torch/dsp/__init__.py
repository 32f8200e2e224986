from audioflux_torch.dsp.resample import (  # noqa: F401
    Resample, WindowResample, resample)
