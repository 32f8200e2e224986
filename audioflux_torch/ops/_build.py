"""Build ``audioflux_torch/csrc/*.cu`` with ``nvcc`` at first use and load
each library with ctypes.

One shared library per source, with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes).  The libraries go to
``audioflux_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded.  A source may include a header that a module of the port
generates (``median_filter.cu`` includes the networks that
``ops/median_network.py`` builds): it is written next to the library and
its text is part of the hash.  Nothing is built when the package is
imported; a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from audioflux_torch.ops import median_network

__all__ = ["SOURCES", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fft_pow2", "fused_mel_mfcc", "median_filter", "cwt_ifft_bank",
           "unwrap_diff", "columnar_scatter")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

# the headers generated for a source: {source: {file name: text maker}}
GENERATED = {
    "median_filter": {"median_networks.cuh": median_network.header_text},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _generated(name: str) -> dict:
    """{file name: text} of the headers generated for ``csrc/<name>.cu``."""
    return {file: make() for file, make in GENERATED.get(name, {}).items()}


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    for file, text in sorted(_generated(name).items()):
        h.update(file.encode())
        h.update(text.encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: ptxas report}`` (empty
    strings unless ``verbose``) for the sources compiled by this call."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        include = []
        generated = _generated(name)
        if generated:
            gen = out.with_suffix(".include")
            gen.mkdir(exist_ok=True)
            for file, text in generated.items():
                (gen / file).write_text(text)
            include = ["-I", str(gen)]
        cmd = [nvcc, *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               *include, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
