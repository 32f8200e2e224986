"""Misc utilities: audio validation, channel reshaping, f0 synthesis.

Reference ``python/audioflux/utils/util.py`` + ``src/util/flux_util.c``.

A copy of ``audioflux_tpu/utils/util.py`` (numpy only).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["check_audio", "check_audio_length", "format_channel",
           "revoke_channel", "synth_f0", "ascontiguous_T",
           "ascontiguous_swapaxex"]


def check_audio(X, is_mono: bool = True) -> bool:
    X = np.asarray(X)
    if not np.issubdtype(X.dtype, np.floating):
        raise ValueError(f"audio dtype must be floating, got {X.dtype}")
    if is_mono and X.ndim != 1:
        raise ValueError("audio must be mono (1-D)")
    return True


def check_audio_length(X, radix2_exp: int):
    """Pad with zeros (or truncate) the last axis to ``2**radix2_exp``,
    warning either way (reference ``utils/util.py`` check_audio_length)."""
    X = np.asarray(X)
    data_len = X.shape[-1]
    fft_length = 1 << radix2_exp
    if data_len < fft_length:
        pad_len = fft_length - data_len
        warnings.warn(
            f"The audio length={data_len} is not enough for "
            f"fft_length={fft_length}(2**radix2_exp), and {pad_len} zeros "
            f"are automatically filled after the audio")
        X = np.pad(X, (*[(0, 0)] * (X.ndim - 1), (0, pad_len)))
    elif data_len > fft_length:
        warnings.warn(
            f"fft_length={fft_length}(2**radix2_exp) is too small for "
            f"data_arr length={data_len}, only the first "
            f"fft_length={fft_length} data are valid")
        X = X[..., :fft_length].copy()
    return X


def ascontiguous_T(X, dtype=None, *args, **kwargs):
    """Transposed array, C-contiguous (reference utils helper)."""
    return np.ascontiguousarray(np.asarray(X).T, dtype=dtype,
                                *args, **kwargs)


def ascontiguous_swapaxex(X, axis1: int, axis2: int, dtype=None,
                          *args, **kwargs):
    """Swap two axes, C-contiguous (reference utils helper; the
    reference spells it 'swapaxex' and so do we, for drop-in parity)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(X), axis1, axis2),
                                dtype=dtype, *args, **kwargs)


def format_channel(X: np.ndarray, last_fixed_ndim: int):
    """Collapse leading dims into one channel axis; returns (X2, lead_shape)."""
    shape = X.shape
    lead = shape[:-last_fixed_ndim] if last_fixed_ndim else shape
    tail = shape[len(lead):]
    return X.reshape((-1,) + tail), lead


def revoke_channel(X: np.ndarray, target_channel_shape, last_fixed_ndim: int):
    return X.reshape(tuple(target_channel_shape) + X.shape[1:])


def synth_f0(times, frequencies, samplate: int, amplitudes=None):
    """Synthesize audio following an f0 trajectory
    (util_synthF0, flux_util.c:829-870): linear interp of frequency (and
    amplitude) onto the sample grid, cumulative phase, sine."""
    times = np.asarray(times, np.float64)
    freqs = np.asarray(frequencies, np.float64)
    n = int(np.floor(times[-1] * samplate))
    t_samples = times * samplate
    w = freqs * (2 * np.pi / samplate)
    grid = np.arange(n)
    w_i = np.interp(grid, t_samples, w)
    if amplitudes is not None:
        a_i = np.interp(grid, t_samples, np.asarray(amplitudes, np.float64))
    else:
        a_i = 1.0
    phase = np.cumsum(w_i)
    return (np.sin(phase) * a_i).astype(np.float32)
