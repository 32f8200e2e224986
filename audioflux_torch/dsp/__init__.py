from audioflux_torch.dsp.resample import (  # noqa: F401
    Resample, WindowResample, resample)
from audioflux_torch.dsp.czt import CZT, czt  # noqa: F401
from audioflux_torch.dsp.xcorr import Xcorr, XcorrNormalType, xcorr  # noqa: F401
from audioflux_torch.dsp.hilbert import Hilbert, hilbert  # noqa: F401
from audioflux_torch.dsp.dct import DCT, dct, idct  # noqa: F401
from audioflux_torch.dsp.phase_vocoder import phase_vocoder  # noqa: F401
from audioflux_torch.dsp.filter_design import (  # noqa: F401
    FilterBandType, fir1, fir2, smooth1, filter_, filtfilt,
    freqz_ba, freqz_sos,
)
from audioflux_torch.dsp.conv import ConvModeType, conv  # noqa: F401
