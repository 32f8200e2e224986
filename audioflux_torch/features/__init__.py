from audioflux_torch.features.xxcc import XXCC
from audioflux_torch.features.spectral import Spectral
from audioflux_torch.features.deconv import Deconv
