"""Phase vocoder time-scale modification of an STFT matrix.

Counterpart of ``audioflux_tpu/dsp/phase_vocoder.py`` (reference
``src/dsp/phase_vocoder.c``): output frame i interpolates the magnitudes of
input frames floor(i*rate) and +1 and advances an accumulated phase by the
wrapped instantaneous-frequency deviation.

The TPU package adds the phase up step by step in float32 (``lax.scan``).
Here every step's increment is computed in float32 as there, and the
accumulation is one prefix sum over the frames in float64, whose sine and
cosine are also taken in float64: the phase grows to about pi*slide*T,
where a float32 sum would lose whole radians over a long input and its
order (sequential on the CPU, a parallel scan on the card) would decide
them.  Magnitudes do not depend on the phase; the complex output differs
from the TPU package's by that package's own float32 drift.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.transforms.stft import _as_complex

__all__ = ["phase_vocoder"]


def phase_vocoder(D, slide_length: int, rate: float, device=None):
    """D: complex (..., fre, time) -> (..., fre, ceil(time/rate))."""
    dev = resolve_device(device)
    Dt = _as_complex(D, dev).transpose(-1, -2)      # (..., T, m)
    T, m = Dt.shape[-2], Dt.shape[-1]
    t_len = int(np.ceil(T / rate))
    phi = as_tensor(np.linspace(0.0, np.pi * slide_length, m), dev)
    times = np.arange(0, T, float(rate), dtype=np.float64)[:t_len]
    ks = np.floor(times).astype(np.int64)
    alphas = as_tensor((times - np.floor(times))[:, None], dev)

    def frames(k):
        """Input frames k (clipped), zero where k >= T."""
        got = Dt[..., torch.from_numpy(np.clip(k, 0, T - 1)).to(dev), :]
        keep = torch.from_numpy(k < T).to(dev)[:, None]
        return torch.where(keep, got, 0)

    A, B = frames(ks), frames(ks + 1)
    mags = (1.0 - alphas) * A.abs() + alphas * B.abs()
    dev_phase = torch.angle(B) - torch.angle(A) - phi
    dev_phase = dev_phase - 2 * np.pi * torch.round(dev_phase / (2 * np.pi))
    inc = phi.double() + dev_phase.double()
    # output frame i: the first frame's phase plus the increments of the
    # frames before i
    phase = torch.angle(Dt[..., :1, :]).double() + torch.cumsum(
        F.pad(inc[..., :-1, :], (0, 0, 1, 0)), dim=-2)
    out = torch.polar(mags.double(), phase).to(torch.complex64)
    return out.transpose(-1, -2)
