"""Observability: the port's spans, profiler traces, and lightweight
metrics.

Counterpart of ``audioflux_tpu/observe.py``.  Three pieces, free when
unused:

- ``scope(name)``: the one way the port opens a span.  While a profiler
  records (``torch.profiler.profile``, or ``torch.autograd.profiler``), it
  is a ``torch.profiler.record_function`` range: a ``user_annotation``
  event on the profiler's clock, nested by time under the caller's spans,
  in the same trace as the CUDA kernels launched inside it.  Otherwise it
  is one shared no-op context, and costs a check of the profiler's state.
  The port's spans are ``af.<Class>.<method>`` around the entry calls and
  ``af.kernel.<wrapper>`` around each kernel wrapper (``PERF.md`` section 3
  lists them).  For NVTX ranges, run the code under
  ``torch.autograd.profiler.emit_nvtx()``, which records the same spans.
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

__all__ = ["scope", "trace", "summarize_trace", "Metrics", "metrics"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()   # the span while no profiler records


def scope(name: str):
    """A span named ``name`` around a ``with`` block: a
    ``torch.profiler.record_function`` range while a profiler records, else
    a shared no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


def summarize_trace(logdir: str, top: int = 25, include_host: bool = False):
    """Per-op durations from the newest trace under ``logdir``.

    Returns ``[(op_name, total_us, count), ...]`` sorted by total time,
    parsed from the ``trace.json.gz`` a :func:`trace` capture writes.
    Where the trace holds device operations (CUDA kernels, copies and
    sets), only those are ranked; a trace of the CPU alone ranks its
    operators and spans.  ``include_host`` ranks every host event beside
    them, the Python-function events too (left out by default: host events
    nest, so their times double-count the work they wrap)."""
    import collections
    import glob
    import json
    paths = sorted(glob.glob(
        f"{logdir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {logdir}")
    with gzip.open(paths[-1]) as fh:
        tr = json.load(fh)
    events = [e for e in tr.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if not include_host:
        events = device or [e for e in events
                            if not e.get("name", "").startswith("$")
                            and e.get("cat") != "python_function"]
    durs = collections.defaultdict(float)
    cnt = collections.Counter()
    for e in events:
        name = e.get("name", "")
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
