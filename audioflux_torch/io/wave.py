"""WAV I/O (pure NumPy + stdlib; no external audio deps).

A copy of ``audioflux_tpu/io/wave.py``.  Covers the reference's audio
surface (``python/audioflux/audio.py`` and the C streaming objects
``src/util/flux_wave.c``): one-shot read/write, streaming
WaveReader/WaveWriter, chirp synthesis, and mono conversion.  Host-side
only: decoded float32 buffers are handed to the plans, which upload them.
One repair against the copy: 32-bit PCM is scaled in float64, so that a
sample of exactly 1.0 becomes 2**31 - 1 instead of overflowing (float32
rounds 1.0 * (2**31 - 1) up to 2**31).
"""

from __future__ import annotations

import wave as _wave

import numpy as np

__all__ = ["read", "write", "WaveReader", "WaveWriter", "chirp", "convert_mono"]


def _decode(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).T  # (channels, samples)
    return data


def _read_one(path, is_mono):
    with _wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    data = _decode(raw, sw, ch)
    if is_mono:
        data = convert_mono(data)
    elif data.ndim == 1:
        data = data.reshape(1, -1)
    return data, sr


def read(path=None, dir=None, is_mono: bool = True, samplate: int = None,
         re_type: str = "scipy"):
    """Load PCM WAV audio — full reference surface (``audio.py:22-107``):
    ``path`` a str or a list of paths (stacked on axis 0; rates and
    shapes must agree), ``dir`` overrides ``path`` with every file in a
    directory, ``samplate`` resamples on read via :func:`resample`.
    Returns (audio float32, samplate)."""
    import os as _os
    import warnings as _warnings
    if dir is not None:
        path = [_os.path.join(dir, f) for f in _os.listdir(dir)]
    if isinstance(path, (str, bytes, _os.PathLike)):
        data, sr = _read_one(path, is_mono)
    else:
        sr = None
        datas = []
        shape = None
        for fp in path:
            try:
                d, _sr = _read_one(fp, is_mono)
            except Exception as e:  # mirror the reference's skip-and-warn
                _warnings.warn(f"Load file error, skip: {fp}, {e}")
                continue
            if sr is None:
                sr = _sr
            elif sr != _sr:
                raise ValueError("When loading multiple audio files, the "
                                 "sampling rate must be the same")
            if shape is None:
                shape = d.shape
            elif shape != d.shape:
                raise ValueError("When loading multiple audio files, the "
                                 "audio shape must be the same")
            datas.append(d)
        data = np.stack(datas, axis=0)
    if samplate is not None and samplate != sr:
        from audioflux_torch.dsp.resample import resample as _mod_resample
        data = _mod_resample(data, sr, samplate, re_type=re_type)
        sr = samplate
    return data, sr


def write(path, data, samplate: int = 32000, subtype: str = "PCM_32",
          format: str = "WAV"):
    """Write float32 audio (mono (n,) or (channels, n)) to a PCM WAV file
    (reference default subtype PCM_32, ``audio.py:118``)."""
    if format.upper() != "WAV":
        raise ValueError(f"format={format} not supported (WAV only)")
    data = np.asarray(data, dtype=np.float32)
    nch = 1 if data.ndim == 1 else data.shape[0]
    if data.ndim == 2:
        data = data.T.reshape(-1)  # interleave
    width = {"PCM_16": 2, "PCM_32": 4}.get(subtype, 4)
    pcm = np.clip(data, -1.0, 1.0)
    if width == 2:
        pcm = (pcm * 32767.0).astype("<i2")
    else:
        pcm = (pcm.astype(np.float64) * 2147483647.0).astype("<i4")
    with _wave.open(str(path), "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(width)
        w.setframerate(samplate)
        w.writeframes(pcm.tobytes())


class WaveReader:
    """Streaming WAV reader (chunked), mirroring waveReadObj_* semantics."""

    def __init__(self, file_path):
        self._w = _wave.open(str(file_path), "rb")
        self.samplate = self._w.getframerate()
        self.channel_num = self._w.getnchannels()
        self.sample_width = self._w.getsampwidth()
        self.total_frames = self._w.getnframes()

    def get_infor(self) -> dict:
        """Wave metadata dict (waveReadObj_getInfor)."""
        return {"samplate": self.samplate,
                "bit": self.sample_width * 8,
                "channel_num": self.channel_num}

    def read(self, n: int) -> np.ndarray:
        raw = self._w.readframes(n)
        if not raw:
            return np.zeros((0,), dtype=np.float32)
        data = _decode(raw, self.sample_width, self.channel_num)
        return data

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WaveWriter:
    """Streaming WAV writer, mirroring waveWriteObj_* semantics."""

    def __init__(self, file_path, samplate: int = 32000, bit: int = 16,
                 channel_num: int = 1):
        if bit not in (16, 32):
            raise ValueError("bit must be 16 or 32")
        self._w = _wave.open(str(file_path), "wb")
        self._w.setnchannels(channel_num)
        self._w.setsampwidth(bit // 8)
        self._w.setframerate(samplate)
        self._width = bit // 8

    def write(self, data_arr: np.ndarray):
        data = np.asarray(data_arr, dtype=np.float32)
        if data.ndim == 2:
            data = data.T.reshape(-1)
        pcm = np.clip(data, -1.0, 1.0)
        if self._width == 2:
            pcm = (pcm * 32767.0).astype("<i2")
        else:
            pcm = (pcm.astype(np.float64) * 2147483647.0).astype("<i4")
        self._w.writeframes(pcm.tobytes())

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def chirp(fmin: float, fmax: float, duration: float, samplate: int = 32000,
          phi: float | None = None, method: str = "logarithmic",
          linear: bool = False) -> np.ndarray:
    """Swept-frequency sinusoid (``audio.py:224-267``): same signature and
    scipy.signal.chirp dispatch as the reference (method one of linear /
    quadratic / logarithmic / hyperbolic; ``phi`` in radians).  The extra
    ``linear=True`` flag is kept as an alias of ``method='linear'``."""
    import scipy.signal
    if fmin <= 0 or fmax <= 0:
        raise ValueError("fmax and fmin must be strictly positive")
    if linear:
        method = "linear"
    t = np.arange(duration, step=1.0 / samplate)
    if phi is None:
        phi = 0.5 * -np.pi
    return scipy.signal.chirp(t, fmin, duration, fmax, method=method,
                              phi=phi / np.pi * 180)


def convert_mono(x: np.ndarray) -> np.ndarray:
    """Average the channel axis (axis -2, like the reference's
    ``audio.py:156-173``); accepts (n,), (channels, n), (batch,
    channels, n)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim > 1:
        x = x.mean(axis=-2)
    return x
