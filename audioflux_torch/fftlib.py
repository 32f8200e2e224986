"""FFT-backend introspection compat (reference ``python/audioflux/fftlib.py``).

Counterpart of ``audioflux_tpu/fftlib.py``.  The reference lets users point
its ctypes layer at different compiled FFT libraries (FFTW, vDSP, ...).
Here the FFTs are ``torch.fft`` and, for pow2 2048..32768 on the card, the
port's own CUDA kernels (``ops.cuda_fft``); there is nothing to choose, so
the setter is a no-op kept for code that imports these names.
"""

import hashlib

__all__ = ["get_fft_lib", "get_fft_lib_fp", "get_fft_lib_name",
           "get_lib_md5", "set_fft_lib"]


def get_fft_lib_name(system=None, lib_ext=None) -> str:
    """``"cuda"`` when a CUDA device is available (where the plans run by
    default), else ``"cpu"``.  ``system`` and ``lib_ext`` (the reference's
    library-picking arguments) are accepted and ignored."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def get_fft_lib():
    """The module providing FFTs (``torch.fft``; the reference returns its
    loaded CDLL)."""
    import torch
    return torch.fft


def get_fft_lib_fp() -> str:
    """Path of the compute library (the ``torch`` package)."""
    import torch
    return torch.__file__


def get_lib_md5() -> str:
    """MD5 of the backing library's identity: the torch and CUDA versions
    and the backend name."""
    import torch
    key = f"torch-{torch.__version__}-cuda-{torch.version.cuda}-" \
          f"{get_fft_lib_name()}"
    return hashlib.md5(key.encode()).hexdigest()


def set_fft_lib(system=None, *, lib_ext=None, path=None):
    """No-op: the FFT backend is fixed.  Accepts and ignores the
    reference's library-picking arguments."""
    return None
