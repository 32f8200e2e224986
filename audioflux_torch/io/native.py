"""ctypes binding for the native C++ IO layer (``native/wavio.cpp``).

The API of ``audioflux_tpu/io/native.py`` over the same source.  The
library is compiled with g++ at first use into
``audioflux_torch/_build/libafio-<hash>.so`` by ``ops/_build.py`` (the JAX
package builds its own copy elsewhere, and the two never race on one
file).  A failed build or load raises, with g++'s message, when the
native path is asked for; :func:`available` reports it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from audioflux_torch.ops import _build

__all__ = ["available", "wav_info", "wav_read", "wav_write", "load_batch",
           "PrefetchLoader", "library_path"]


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    return _build.library_path("libafio")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = _build.load("libafio")
    lib.afio_wav_info.restype = ctypes.c_long
    lib.afio_wav_read.restype = ctypes.c_long
    lib.afio_wav_write.restype = ctypes.c_int
    lib.afio_load_batch.restype = ctypes.c_int
    lib.afio_pool_create.restype = ctypes.c_void_p
    lib.afio_pool_create.argtypes = [ctypes.c_int]
    lib.afio_pool_submit.restype = ctypes.c_int
    lib.afio_pool_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.afio_pool_wait.restype = ctypes.c_int
    lib.afio_pool_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.afio_pool_destroy.restype = None
    lib.afio_pool_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load()
    except OSError:
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path: str):
    """(frames, samplate, channels), or None if the file is not a WAV the
    decoder reads."""
    lib = _load()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.afio_wav_info(str(path).encode(), ctypes.byref(sr),
                          ctypes.byref(ch))
    if n < 0:
        return None
    return int(n), sr.value, ch.value


def wav_read(path: str, is_mono: bool = True):
    """(audio float32, samplate) through the native decoder."""
    lib = _load()
    info = wav_info(path)
    if info is None:
        raise IOError(f"cannot read {path}")
    frames, sr, ch = info
    out_ch = 1 if is_mono else ch
    buf = np.zeros(frames * out_ch, np.float32)
    n = lib.afio_wav_read(str(path).encode(), _fptr(buf),
                          ctypes.c_long(frames),
                          ctypes.c_int(1 if is_mono else 0))
    if n < 0:
        raise IOError(f"decode failed for {path}")
    if not is_mono and ch > 1:
        return buf[:n * ch].reshape(n, ch).T.copy(), sr
    return buf[:n], sr


def wav_write(path: str, data, samplate: int = 32000):
    """Write float32 audio, (n,) or (channels, n), as a WAV file."""
    lib = _load()
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    if data.ndim == 1:
        frames, ch = len(data), 1
    else:
        ch, frames = data.shape
        data = np.ascontiguousarray(data.T)
    rc = lib.afio_wav_write(str(path).encode(), _fptr(data),
                            ctypes.c_long(frames), ctypes.c_int(ch),
                            ctypes.c_int(samplate))
    if rc != 0:
        raise IOError(f"write failed for {path}")


class PrefetchLoader:
    """Asynchronous, double-buffered batch loader over the native worker
    pool: decodes the next ``depth`` batches on C++ threads while the
    caller consumes the current one.  Yields ``(batch, good)``, batch
    (B, length) float32 mono (truncated or zero-padded), ``good`` the
    count of files decoded.  Use as a context manager or call
    :meth:`close`."""

    def __init__(self, paths, batch_size: int, length: int,
                 num_threads: int = 4, depth: int = 2):
        if batch_size < 1 or length < 1 or depth < 1:
            raise ValueError("batch_size, length and depth must be >= 1")
        self._lib = _load()
        paths = list(paths)
        self._paths = [paths[i:i + batch_size]
                       for i in range(0, len(paths), batch_size)]
        self._length = int(length)
        self._depth = int(depth)
        self._pool = self._lib.afio_pool_create(int(num_threads))
        self._pending = {}  # job id -> output array
        self._closed = False

    def _submit(self, chunk):
        out = np.zeros((len(chunk), self._length), np.float32)
        jid = self._lib.afio_pool_submit(
            self._pool, "\n".join(chunk).encode(), len(chunk), _fptr(out),
            ctypes.c_long(self._length))
        if jid < 0:
            raise IOError("prefetch submit failed")
        self._pending[jid] = out
        return jid

    def __iter__(self):
        if self._closed:
            raise RuntimeError("loader is closed")
        order = []
        it = iter(self._paths)
        for chunk in it:
            order.append(self._submit(chunk))
            if len(order) >= self._depth:
                break
        for chunk in it:
            jid = order.pop(0)
            nxt = self._submit(chunk)  # keep the pipeline full
            good = self._lib.afio_pool_wait(self._pool, jid)
            yield self._pending.pop(jid), int(good)
            order.append(nxt)
            if self._closed:  # the consumer closed mid-stream
                return
        while order:
            jid = order.pop(0)
            if self._closed:
                return
            good = self._lib.afio_pool_wait(self._pool, jid)
            yield self._pending.pop(jid), int(good)

    def close(self):
        if not self._closed:
            # wait for what was submitted, so that no thread writes into a
            # freed buffer
            for jid in list(self._pending):
                self._lib.afio_pool_wait(self._pool, jid)
                self._pending.pop(jid, None)
            self._lib.afio_pool_destroy(self._pool)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_batch(paths, length: int, num_threads: int = 4):
    """Decode many WAVs mono into a (len(paths), length) float32 batch
    (truncated or zero-padded) on native threads.  Returns
    (batch, count of files decoded)."""
    lib = _load()
    paths = [str(p) for p in paths]
    out = np.zeros((len(paths), length), np.float32)
    good = lib.afio_load_batch(
        "\n".join(paths).encode(), ctypes.c_int(len(paths)), _fptr(out),
        ctypes.c_long(length), ctypes.c_int(num_threads))
    return out, int(good)
