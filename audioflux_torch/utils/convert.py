"""Note / MIDI / Hz conversions (the part of the JAX package's
``utils/convert.py`` that the spectrogram constructors use).

Semantics follow the reference ``python/audioflux/utils/convert.py``.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["note_to_midi", "midi_to_hz", "hz_to_midi", "note_to_hz"]

_NOTE_MAP = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_ACC_MAP = {"": 0, "#": 1, "♯": 1, "b": -1, "♭": -1, "!": -1,
            "##": 2, "bb": -2, "x": 2}
_NOTE_RE = re.compile(r"^([A-Ga-g])([#♯b♭!x]{0,2})(-?\d+)?$")


def note_to_midi(note: str) -> float:
    m = _NOTE_RE.match(note.strip())
    if not m:
        raise ValueError(f"invalid note {note!r}")
    letter, acc, octave = m.groups()
    octave = 0 if octave is None else int(octave)
    return _NOTE_MAP[letter.upper()] + _ACC_MAP.get(acc, 0) + 12 * (octave + 1)


def midi_to_hz(midi):
    return 440.0 * np.power(2.0, (np.asarray(midi, dtype=np.float64) - 69) / 12.0)


def hz_to_midi(frequencies):
    return 12.0 * np.log2(np.asarray(frequencies, dtype=np.float64) / 440.0) + 69.0


def note_to_hz(note: str) -> float:
    return float(midi_to_hz(note_to_midi(note)))
