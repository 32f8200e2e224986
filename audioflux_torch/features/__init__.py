from audioflux_torch.features.xxcc import XXCC
