"""Observability: profiler traces, named stages, and lightweight metrics.

Counterpart of ``audioflux_tpu/observe.py``.  Three pieces, free when
unused:

- ``scope(name)``: a ``torch.profiler.record_function`` range, plus an
  NVTX range when CUDA is available, so that the ops inside group under a
  readable stage name in a trace.
- ``trace(logdir)``: ``torch.profiler.profile`` over the enclosed code (the
  CPU and, when available, CUDA activity); its Chrome trace is written,
  gzipped, to ``logdir/plugins/profile/<run>/<host>.trace.json.gz``, where
  :func:`summarize_trace` reads it.
- ``metrics``: a process-wide registry of counters and wall-clock timers
  (``with metrics.timer("stage"): ...``); ``metrics.report()`` returns a
  plain dict.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import shutil
import socket
import time
from collections import defaultdict

import torch

__all__ = ["scope", "trace", "annotate", "summarize_trace", "Metrics",
           "metrics"]


@contextlib.contextmanager
def scope(name: str):
    """Named stage scope: groups ops under ``name`` in profiler traces."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a ``torch.profiler`` trace of the enclosed computation into
    ``logdir`` (``create_perfetto_link``, a JAX option, is accepted and
    ignored).  Returns the profiler, whose ``key_averages()`` the caller
    may read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        run = os.path.join(logdir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S")
                           + f"_{time.perf_counter_ns() % 10**6:06d}")
        os.makedirs(run, exist_ok=True)
        raw = os.path.join(run, f"{socket.gethostname()}.trace.json")
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(raw)


def annotate(name: str):
    """Host-side trace annotation (a range on the profiler's host track)."""
    return torch.profiler.record_function(name)


def summarize_trace(logdir: str, top: int = 25, include_host: bool = False):
    """Per-op durations from the newest trace under ``logdir``.

    Returns ``[(op_name, total_us, count), ...]`` sorted by total time,
    parsed from the ``trace.json.gz`` a :func:`trace` capture writes.
    ``include_host`` keeps the Python-function events (dropped by default:
    they double-count the work they wrap)."""
    import collections
    import glob
    import json
    paths = sorted(glob.glob(
        f"{logdir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {logdir}")
    with gzip.open(paths[-1]) as fh:
        tr = json.load(fh)
    durs = collections.defaultdict(float)
    cnt = collections.Counter()
    for e in tr.get("traceEvents", []):
        name = e.get("name", "")
        if e.get("ph") != "X":
            continue
        if not include_host and (name.startswith("$")
                                 or e.get("cat") == "python_function"):
            continue
        durs[name] += float(e.get("dur", 0))
        cnt[name] += 1
    rows = sorted(durs.items(), key=lambda kv: -kv[1])[:top]
    return [(n, d, cnt[n]) for n, d in rows]


class Metrics:
    """Tiny counter/timer registry for pipeline observability."""

    def __init__(self):
        self._counters = defaultdict(float)
        self._times = defaultdict(float)
        self._calls = defaultdict(int)

    def count(self, name: str, value: float = 1.0):
        self._counters[name] += value

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._times[name] += dt
            self._calls[name] += 1

    def report(self) -> dict:
        out = {}
        for k, v in sorted(self._counters.items()):
            out[k] = v
        for k, v in sorted(self._times.items()):
            out[k + ".seconds"] = v
            out[k + ".calls"] = self._calls[k]
        return out

    def reset(self):
        self._counters.clear()
        self._times.clear()
        self._calls.clear()


metrics = Metrics()
