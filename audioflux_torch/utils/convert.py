"""Conversion utilities (dB scaling, deltas, note/midi/hz, samples).

Counterpart of ``audioflux_tpu/utils/convert.py``: the array functions on
tensors (host data becomes a CPU tensor; a tensor stays on its device),
the note and sample helpers on the host.  Semantics follow the reference
``src/util/flux_util.c`` (powerToDB family) and
``python/audioflux/utils/convert.py``.  One deliberate difference: the
synthesized samples seed their noise from a CRC of the name, the same in
every process, where the JAX package seeds from ``hash(name)``, which
Python salts per process.
"""

from __future__ import annotations

import math
import re
import zlib

import numpy as np
import torch

__all__ = [
    "power_to_db", "power_to_abs_db", "mag_to_abs_db",
    "log_compress", "log10_compress", "delta", "get_phase",
    "note_to_midi", "midi_to_note", "note_to_hz", "midi_to_hz", "hz_to_midi",
    "hz_to_note", "temproal_db", "sample_path",
]


def _t(X) -> torch.Tensor:
    return X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))


def _floor(v: torch.Tensor, min_db: float) -> torch.Tensor:
    return torch.maximum(v, torch.tensor(min_db, dtype=v.dtype,
                                         device=v.device))


def power_to_db(X, min_db: float = -80.0):
    """Relative dB: 10*log10(p/max(p)), floored at ``min_db``.

    The max is global over the whole array (reference util_powerToDB,
    flux_util.c).
    """
    X = _t(X)
    return _floor(10.0 * torch.log10(X / X.max()), min_db)


def _abs_db(X, scale: float, ref: float, is_norm: bool, min_db: float):
    X = _t(X)
    v = _floor(scale * torch.log10(X / ref), min_db)
    if is_norm:
        # reference: subtract from the dB value at the power argmax
        v = v.reshape(-1)[torch.argmax(X)] - v
    return v


def power_to_abs_db(X, fft_length: int = 4096, is_norm: bool = False,
                    min_db: float = -80.0):
    """Absolute dB: 10*log10(p/fft_length^2), floored at ``min_db``."""
    return _abs_db(X, 10.0, float(fft_length) ** 2, is_norm, min_db)


def mag_to_abs_db(X, fft_length: int = 4096, is_norm: bool = False,
                  min_db: float = -80.0):
    """Absolute dB from magnitude: 20*log10(m/fft_length)."""
    return _abs_db(X, 20.0, float(fft_length), is_norm, min_db)


def log_compress(X, gamma: float = 1.0):
    """ln(1 + gamma * X)"""
    return torch.log1p(gamma * _t(X))


def log10_compress(X, gamma: float = 1.0):
    """log10(1 + gamma * X)"""
    return torch.log1p(gamma * _t(X)) / math.log(10.0)


def delta(X, order: int = 9):
    """Delta features with the reference's exact semantics.

    The reference swaps time/fre and feeds rows to ``util_delta``
    (convert.py:291-308), so the filter runs along the FREQUENCY axis;
    ``util_delta`` itself is a CAUSAL direct-form FIR with the
    smoothing-derivative kernel [m..-m]/sum(i^2, i=1..m)
    (filterDesign_smooth1 + filterDesign_filter, zero initial state,
    not a centered window).
    """
    if order < 3 or order % 2 == 0:
        raise ValueError("order must be odd and >= 3")
    X = _t(X).to(torch.float32)
    if X.ndim < 2:
        raise ValueError("The dimension should be greater than equal to 2")
    m = order // 2
    v1 = float(sum(i * i for i in range(1, m + 1)))
    b = np.arange(m, -m - 1, -1, dtype=np.float32) / np.float32(v1)
    F = X.shape[-2]
    # y[f] = sum_j b[j] * x[f-j] with zeros before f=0 (causal)
    Xp = torch.nn.functional.pad(X, (0, 0, order - 1, 0))
    out = torch.zeros_like(X)
    for j in range(order):
        out = out + float(b[j]) * Xp[..., order - 1 - j:order - 1 - j + F, :]
    return out


def get_phase(D, eps: float = 1e-16):
    """Phase angle of a complex spectrogram."""
    D = _t(D)
    re = torch.where(D.real < eps, torch.full_like(D.real, eps), D.real)
    return torch.arctan2(D.imag, re)


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


def midi_to_note(midi, is_octave: bool = True) -> str:
    names = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
    midi = int(round(float(midi)))
    name = names[midi % 12]
    return f"{name}{midi // 12 - 1}" if is_octave else name


def midi_to_hz(midi):
    return 440.0 * np.power(2.0, (np.asarray(midi, dtype=np.float64) - 69) / 12.0)


def hz_to_midi(frequencies):
    return 12.0 * np.log2(np.asarray(frequencies, dtype=np.float64) / 440.0) + 69.0


def note_to_hz(note: str) -> float:
    return float(midi_to_hz(note_to_midi(note)))


def hz_to_note(frequencies) -> str:
    """Frequency (Hz) -> note name (utils/convert.py:529 in the reference)."""
    return midi_to_note(hz_to_midi(frequencies))


def temproal_db(X, base: float = 18.0):
    """Time-domain dB stats of a clip -> (max_db, avg_db, percent).

    Port of ``util_temproal`` (reference ``src/util/flux_util.c:652-684``;
    the reference wrapper spells it 'temproal' and so do we): per-sample
    20*log10(|x|+1e-8) floored at -36 dB; ``percent`` is the fraction of
    samples quieter than ``-base`` dB.
    """
    X = np.asarray(X, np.float32)
    if X.ndim != 1:
        raise ValueError(f"X[ndim={X.ndim}] must be a 1D array")
    if X.size == 0:
        return 0.0, 0.0, 0.0
    v = 20.0 * np.log10(np.abs(X) + np.float32(1e-8))
    v = np.maximum(v, -36.0)
    count = int(np.sum(v > -base))
    return (float(np.max(v)), float(np.sum(v) / len(v)),
            float((len(v) - count) / len(v)))


def _synth_sample(name: str, sr: int = 32000) -> np.ndarray:
    """Synthetic stand-in for the reference's bundled sample WAVs
    (``utils/sample_data/``: 220/880/voice/guitar_chord1-2/
    chord_metronome1-2).  The real recordings are not redistributed;
    each stand-in matches the character the docs/examples rely on
    (a pitched tone, a sung phrase, decaying plucked chords, chords
    with a click track)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    t = np.arange(3 * sr) / sr

    def pluck(f0, start, dur=1.2, amp=0.5):
        n0 = int(start * sr)
        seg = np.zeros_like(t)
        tt = np.arange(int(dur * sr)) / sr
        s = np.zeros_like(tt)
        for k, a in enumerate([1.0, 0.6, 0.4, 0.25, 0.15, 0.08], start=1):
            s += a * np.sin(2 * np.pi * f0 * k * tt + rng.uniform(0, 6))
        s *= amp * np.exp(-tt * 3.0)
        seg[n0:n0 + len(s)] += s[:max(len(t) - n0, 0)]
        return seg

    if name in ("220", "880"):
        f = float(name)
        x = 0.5 * np.sin(2 * np.pi * f * t[:sr])
    elif name == "voice":
        # glide between note pitches with vibrato + formant-ish harmonics
        notes = [196.0, 220.0, 246.9, 220.0, 196.0, 164.8]
        f0 = np.concatenate([np.full(len(t) // len(notes), f)
                             for f in notes])
        f0 = np.resize(f0, len(t))
        f0 = f0 * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        x = np.zeros_like(t)
        for k, a in [(1, 0.5), (2, 0.35), (3, 0.2), (4, 0.1), (5, 0.05)]:
            x += a * np.sin(k * phase)
        x *= 0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t) ** 2
    elif name.startswith("guitar_chord"):
        root = 110.0 if name.endswith("1") else 146.83
        ratios = [1.0, 1.26, 1.5, 2.0]  # major triad + octave
        x = np.zeros_like(t)
        for i, r in enumerate(ratios):
            x += pluck(root * r, 0.2 + 0.03 * i)
        for i, r in enumerate(ratios):
            x += pluck(root * r * 1.122, 1.6 + 0.03 * i)
    elif name.startswith("chord_metronome"):
        root = 130.8 if name.endswith("1") else 164.8
        x = pluck(root, 0.1, 2.5) + pluck(root * 1.26, 0.12, 2.5) \
            + pluck(root * 1.5, 0.14, 2.5)
        for beat in np.arange(0.0, 3.0, 0.5):
            n0 = int(beat * sr)
            click = 0.4 * np.exp(-np.arange(600) / 60.0) \
                * rng.standard_normal(600)
            x[n0:n0 + 600] += click[:max(len(x) - n0, 0)]
    else:
        f = float(name) if name.replace(".", "").isdigit() else 220.0
        x = 0.5 * np.sin(2 * np.pi * f * t[:sr])
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def sample_path(name: str = "220") -> str:
    """Path to a sample WAV.  Mirrors ``utils.sample_path``
    (``python/audioflux/utils/sample.py:9``).  The reference's recordings
    are not redistributed: a synthesized stand-in with the same broad
    character (:func:`_synth_sample`) is written on first use under
    ``audioflux_torch/utils/sample_data/``."""
    import os
    import wave as _wave

    base = os.path.join(os.path.dirname(__file__), "sample_data")
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"{name}.wav")
    if not os.path.exists(path):
        sr = 32000
        x = _synth_sample(name, sr)
        pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
        tmp = f"{path}.{os.getpid()}.tmp"
        with _wave.open(tmp, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
        os.replace(tmp, path)
    return path
