"""The port's native seam: build its C and C++ sources at first use, load
each library with ctypes, and launch its CUDA kernels.

One shared library per source, with a plain C interface, of two kinds:

* ``csrc/*.cu`` (:data:`SOURCES`), the CUDA kernels, built with ``nvcc``
  for sm_90a (no PyTorch headers, so a build takes seconds, not minutes).
  A source may include a header that a module of the port generates
  (``median_filter.cu`` includes the networks that
  ``ops/median_network.py`` builds): it is written next to the library
  and its text is part of the hash, as are the ``csrc/*.cuh`` headers;
* the host C++ sources (:data:`HOST`), built with ``g++``: the IO layer
  (``native/wavio.cpp``) and the onset peak pick (``csrc/peak_pick.cpp``).

A library goes to ``audioflux_torch/_build/<name>-<hash>.so``, the hash
covering the flags and the source, so an edited source is rebuilt and a
stale library is never loaded.  A build writes a temporary file and
renames it, so processes that build at once never load a half-written
library.  Nothing is built when the package is imported; a missing
compiler or source, or a failed compile, raises ``OSError`` with the
compiler's message.

Every C entry of a kernel takes the stream as its last argument and
returns a CUDA error code; :func:`launch` is the one way the wrappers call
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from audioflux_torch.ops import median_network
from audioflux_torch.ops.backend import require_sm90

__all__ = ["SOURCES", "HOST", "build", "load", "library_path", "launch"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fft_pow2", "fused_mel_mfcc", "median_filter", "cwt_ifft_bank",
           "unwrap_diff", "columnar_scatter", "hpss", "pef", "cqt")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
_HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
# the host libraries: {name: (source, g++ flags)}
HOST = {
    "libafio": (_PKG.parent / "native" / "wavio.cpp",
                [*_HOST_FLAGS, "-pthread"]),
    # no FMA or reassociation: the sums keep numpy's float32 order
    "libafpp": (CSRC / "peak_pick.cpp", [*_HOST_FLAGS, "-ffp-contract=off"]),
}

# the headers generated for a source: {source: {file name: text maker}}
GENERATED = {
    "median_filter": {"median_networks.cuh": median_network.header_text},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_SM90_SEEN: set = set()   # the card indices require_sm90 has passed


def _source(name: str):
    """(compiler, source, flags) of library ``name``."""
    if name in HOST:
        return ("g++", *HOST[name])
    return "nvcc", CSRC / f"{name}.cu", FLAGS


def _which(tool: str) -> str:
    path = shutil.which(tool) or shutil.which(f"/usr/local/cuda/bin/{tool}")
    if path is None:
        raise OSError(f"{tool} not found: the native libraries cannot be "
                      "built")
    return path


def _generated(name: str) -> dict:
    """{file name: text} of the headers generated for ``csrc/<name>.cu``."""
    return {file: make() for file, make in GENERATED.get(name, {}).items()}


def library_path(name: str) -> Path:
    """Where library ``name`` of the current source and flags lies."""
    tool, source, flags = _source(name)
    if not source.exists():
        raise OSError(f"native source {source} is missing")
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    if tool == "nvcc":
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
        for file, text in sorted(_generated(name).items()):
            h.update(file.encode())
            h.update(text.encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict:
    """Compile the named libraries that are not built yet, one compiler
    per library, all started together.  Returns ``{name: compiler
    output}`` for the libraries compiled by this call (``verbose`` adds
    ptxas's report to a CUDA source's)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tool, source, flags = _source(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        extra = ["-Xptxas", "-v"] if verbose and tool == "nvcc" else []
        generated = _generated(name)
        if generated:
            gen = out.with_suffix(".include")
            gen.mkdir(exist_ok=True)
            for file, text in generated.items():
                (gen / file).write_text(text)
            extra += ["-I", str(gen)]
        cmd = [_which(tool), *flags, *extra, "-o", str(tmp), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tool, tmp, out)
    reports, failed = {}, []
    for name, (proc, tool, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{tool} failed to build {out.name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise OSError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def launch(fn, who: str, device: torch.device, *args) -> None:
    """``fn(*args, stream)``: a kernel's C entry on ``device`` and its
    current stream; raise naming ``who`` on a CUDA error.  The host work
    is kept small, since a small call's time is the host's: the card's
    sm_90 check is made once a card, and the device guard is opened only
    off the current card."""
    index = device.index
    if index not in _SM90_SEEN:
        require_sm90(device)
        _SM90_SEEN.add(index)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{who} launch failed: CUDA error {err}")
