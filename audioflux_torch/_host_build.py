"""Build a host C++ source with g++ at first use and load it with ctypes.

The port's host libraries (``native/wavio.cpp``, the IO layer;
``csrc/peak_pick.cpp``, the onset peak pick) go to
``audioflux_torch/_build/<stem>-<hash>.so``.  The hash covers the flags
and the source, so an edited source is rebuilt and a stale library is
never loaded.  A build writes a temporary file and renames it, so
processes that build at once never load a half-written library.  Nothing
is built when the package is imported; a failed build raises ``OSError``
with g++'s message.  The CUDA sources are ``ops/_build.py``'s.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "library_path", "load"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def library_path(source: Path, stem: str, flags,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of ``source`` built with ``flags`` lies."""
    if not source.exists():
        raise OSError(f"native source {source} is missing")
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return build_dir / f"{stem}-{h.hexdigest()[:16]}.so"


def load(source: Path, stem: str, flags,
         build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library of ``source``, built with g++ first if needed."""
    path = library_path(source, stem, flags, build_dir)
    if not path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *flags, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise OSError(f"g++ failed to build {path.name}:\n{proc.stderr}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))
