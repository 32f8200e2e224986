"""WAV input and output: ``io.wave`` (numpy and the standard library) and
``io.native`` (the C++ loader, through ctypes)."""

from audioflux_torch.io.wave import (read, write, WaveReader, WaveWriter,
                                     chirp, convert_mono)
