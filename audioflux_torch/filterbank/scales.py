"""Frequency-scale conversions (mel/bark/erb/midi/log/logspace).

Formulas follow the reference ``src/filterbank/auditory_filterBank.c:1023-1190``.
Computed in float32 to keep band-edge *rounding decisions* identical to the
reference C (bin indices come from ``roundf``/threshold comparisons on
float32 values); callers that don't round may pass float64 inputs.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hz_to_mel", "mel_to_hz", "hz_to_bark", "bark_to_hz",
    "hz_to_erb", "erb_to_hz", "hz_to_midi", "midi_to_hz",
    "hz_to_log", "log_to_hz", "hz_to_logspace", "logspace_to_hz",
]

_ERB_A = np.float32(21.3654)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def hz_to_mel(f):
    """mel = 2595*log10(1 + f/700)"""
    f = _f32(f)
    return np.float32(2595) * np.log10(np.float32(1) + f / np.float32(700))


def mel_to_hz(m):
    m = _f32(m)
    return np.float32(700) * (np.power(np.float32(10), m / np.float32(2595)) - np.float32(1))


def hz_to_bark(f):
    f = _f32(f)
    bark = np.float32(26.81) * f / (np.float32(1960) + f) - np.float32(0.53)
    bark = np.where(bark < 2, bark + np.float32(0.15) * (np.float32(2) - bark), bark)
    bark = np.where(bark > 20.1, bark + np.float32(0.22) * (bark - np.float32(20.1)), bark)
    return bark


def bark_to_hz(bark):
    bark = _f32(bark)
    b = np.where(bark < 2, (bark - np.float32(0.3)) / np.float32(0.85), bark)
    b = np.where(bark > 20.1, (bark + np.float32(4.422)) / np.float32(1.22), b)
    return np.float32(1960) * (b + np.float32(0.53)) / (np.float32(26.28) - b)


def hz_to_erb(f):
    f = _f32(f)
    return _ERB_A * np.log10(np.float32(1) + f * np.float32(0.004368))


def erb_to_hz(erb):
    erb = _f32(erb)
    return (np.power(np.float32(10), erb / _ERB_A) - np.float32(1)) / np.float32(0.004368)


def hz_to_midi(f):
    # C: roundf(12*log2(fre/440)+69) — log2 evaluates in double precision
    f = _f32(f)
    v = 12.0 * np.log2(np.asarray(f, dtype=np.float64) / 440.0) + 69.0
    return np.asarray(np.round(np.asarray(v, dtype=np.float32)), dtype=np.float32)


def midi_to_hz(midi):
    midi = _f32(midi)
    return np.power(np.float32(2), (midi - np.float32(69)) / np.float32(12)) * np.float32(440)


def hz_to_log(f, bin_per_octave=12.0):
    """Octave ("log") scale: round(bin_per_octave * log2(f/440))."""
    f = _f32(f)
    return np.asarray(
        np.round(np.float32(bin_per_octave) * np.log2(f / np.float64(440))),
        dtype=np.float32)


def log_to_hz(v, bin_per_octave=12.0):
    v = _f32(v)
    return np.asarray(np.power(2.0, v / np.float64(bin_per_octave)) * 440.0,
                      dtype=np.float32)


def hz_to_logspace(f):
    f = _f32(f)
    return np.asarray(np.log2(f / np.float64(440)), dtype=np.float32)


def logspace_to_hz(v):
    v = _f32(v)
    return np.asarray(np.power(2.0, np.float64(v)) * 440.0, dtype=np.float32)
