"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything particular to a configuration, a traffic mix or a metric is
found by name (``BENCHMARK.json`` at the root of the checkout):

- ``configs/<config>.json``: the plans' arguments, the entry, the limits;
- ``entries/<entry>.py``: ``Entry(cfg, device)`` with ``call(x, spans)``;
- ``reference/<config>.py``: ``Reference(cfg, device).run(x, precision)``
  and ``compare(got, ref)``;
- ``counts/<config>.py``: the bytes and operations a call needs;
- ``workloads/<cell>.json``: the traffic, read by ``traffic.py``;
- ``metrics/<metric>.py``: ``read(run)``, a number or None.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
import traceback
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from benchmark import traffic
from benchmark.trace import Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audioflux_tpu")
MAX_FAILED = 10


class ChipMissing(RuntimeError):
    pass


# -- discovery -------------------------------------------------------------
def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(bench: dict, name: str, here: Path = HERE) -> dict:
    """The cell ``name``: its entry in ``BENCHMARK.json``, its workload and
    configuration files, and its metrics (end-to-end and per-layer)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    wl = load_json(here / "workloads" / f"{name}.json")
    if wl["config"] != cell["config"]:
        raise ValueError(f"workloads/{name}.json names {wl['config']}, "
                         f"BENCHMARK.json {cell['config']}")
    cfg = load_json(here / "configs" / f"{cell['config']}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "workload": wl, "config": cfg, "here": here,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def module(kind: str, name: str, here: Path = HERE):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (metric names carry dots)."""
    path = here / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"benchmark.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


# -- spans -----------------------------------------------------------------
class Spans:
    """Host-clock spans of the harness's calls into the program, by name;
    while ``profiling`` is set each span is also a profiler annotation
    ``bench.<name>``."""

    def __init__(self):
        self.ns = defaultdict(list)
        self.profiling = False

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    __slots__ = ("owner", "name", "t0", "rf")

    def __init__(self, owner, name):
        self.owner, self.name, self.rf = owner, name, None

    def __enter__(self):
        if self.owner.profiling:
            self.rf = torch.profiler.record_function("bench." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.owner.ns[self.name].append(time.perf_counter_ns() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _NoSpans:
    def span(self, name):
        return contextlib.nullcontext()


# -- the record a metric reads --------------------------------------------
class Run:
    """What one run measured; each ``metrics/<name>.py`` reads it."""

    def __init__(self, parts, device_name):
        self.cell = parts["cell"]
        self.wl = parts["workload"]
        self.cfg = parts["config"]
        self.here = parts["here"]
        self.device_name = device_name
        self.setup_s = None
        self.window_s = None
        self.calls = []            # (start_ns, end_ns, ok)
        self.spans = Spans()
        self.trace = None          # Trace of the traced stretch, or None
        self.request_shape = traffic.request_shape(self.wl)
        self.audio_s = traffic.audio_seconds(self.wl)

    def counts(self):
        return module("counts", self.cfg["name"], self.here)


def rows(x):
    """A request with a leading axis of rows."""
    return x[None] if x.ndim == 1 else x


class ControlEntry:
    """The plain reference, in the configuration's control precision, put
    in the program's place."""

    def __init__(self, cfg, device, precision, here: Path = HERE):
        self.ref = module("reference", cfg["name"], here).Reference(cfg, device)
        self.precision = precision
        self.device = torch.device(device)

    def call(self, x, spans):
        host = isinstance(x, np.ndarray)
        xt = torch.as_tensor(x).to(self.device) if host else x
        out = self.ref.run(rows(xt), self.precision)
        if xt.ndim == 1:
            out = {k: v[0] for k, v in out.items()}
        out = {k: (v if isinstance(v, list) else v.to(torch.float32))
               for k, v in out.items()}
        if host:
            out = {k: (v if isinstance(v, list) else v.cpu().numpy())
                   for k, v in out.items()}
        return out


def build_entry(cfg, device, control=None, here: Path = HERE):
    if control:
        return ControlEntry(cfg, device, control, here)
    return module("entries", cfg["entry"], here).Entry(cfg, device)


# -- the check -------------------------------------------------------------
def check(cfg, pool, kept, device, one_clip: bool, here: Path = HERE) -> dict:
    """Readings of the configuration's comparison over the kept calls,
    ``kept`` being [(pool index, outputs)].  ``one_clip``: each request is
    one clip, and its outputs carry no leading axis of rows."""
    ref_mod = module("reference", cfg["name"], here)
    ref = ref_mod.Reference(cfg, device)
    used = sorted({i for i, _ in kept})
    xs = [rows(torch.as_tensor(pool[i]).to(device)) for i in used]
    bounds = np.cumsum([0] + [x.shape[0] for x in xs])
    ref_all = ref.run(torch.cat(xs), "float64")
    del xs
    span = {i: (bounds[j], bounds[j + 1]) for j, i in enumerate(used)}
    got, want = defaultdict(list), defaultdict(list)
    for i, out in kept:
        a, b = span[i]
        for k, v in out.items():
            r = ref_all[k][a:b]
            if isinstance(v, list):
                got[k].extend(v)
                want[k].extend(r)
                continue
            v = torch.as_tensor(v).to(device)
            got[k].append(v[None] if one_clip else v)
            want[k].append(r)
    cat = lambda d: {k: (v if isinstance(v[0], np.ndarray) else torch.cat(v))
                     for k, v in d.items()}
    return ref_mod.compare(cat(got), cat(want))


# -- one run ---------------------------------------------------------------
def device_for(chips: int, device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ChipMissing("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise ChipMissing(f"the cell needs {chips} cards, "
                          f"{torch.cuda.device_count()} present")
    return torch.device("cuda:0")


def _read_counter(spec: str):
    mod_name, attr = spec.split(":")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, control=None, log=print, here: Path = HERE) -> dict:
    """Run the cell ``name`` once and return its result line (a dict)."""
    parts = cell_parts(bench, name, here)
    cfg, wl = parts["config"], parts["workload"]
    dev = device_for(parts["cell"]["chips"], device)
    gpu = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if gpu else "cpu"
    run = Run(parts, kind)

    # -- set-up: the plans, the pool of requests, every shape warmed -------
    entry = build_entry(cfg, dev, control, here)
    pool = traffic.make_pool(wl, seed, dev)
    keep_n = wl["keep"]
    # warm-up: as many calls as the window's sample will hold and two more,
    # all held, so that the allocator has every block before the window
    held = [entry.call(pool[i % len(pool)], _NoSpans())
            for i in range(keep_n + 2)]
    _sync(dev)
    del held
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if gpu:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    counters = cfg.get("counters", [])
    before = {c: _read_counter(c) for c in counters}
    rng = random.Random(seed)
    kept, failed = [], 0
    trace_lo, trace_hi = 1, 1 + wl.get("trace_calls", 20)
    window_rf = None
    run.setup_s = time.time() - t_start

    # -- the window: a closed loop, one caller ----------------------------
    # the collector stays on: its pauses are part of what a caller's loop
    # pays; set-up's garbage is collected before the window opens
    gc.collect()
    t0 = time.perf_counter()
    i, last = 0, None
    while True:
        if prof is not None and i == trace_lo:
            prof.start()
            run.spans.profiling = True
            window_rf = torch.profiler.record_function("bench.window")
            window_rf.__enter__()
        x = pool[i % len(pool)]
        c0 = time.perf_counter_ns()
        try:
            with run.spans.span("call"):
                out = entry.call(x, run.spans)
            ok = True
        except Exception:  # a failed call is counted, and the loop goes on
            traceback.print_exc()
            ok, out = False, None
            failed += 1
        c1 = time.perf_counter_ns()
        run.calls.append((c0, c1, ok))
        if ok:
            last = (i % len(pool), out)
            if i < keep_n:
                kept.append(last)
            else:
                j = rng.randrange(i + 1)
                if j < keep_n:
                    kept[j] = last
        i += 1
        if prof is not None and i == trace_hi:
            window_rf.__exit__(None, None, None)
            run.spans.profiling = False
            prof.stop()
            run.trace = _read_trace(prof)
            prof = None
            # host-clock spans are read from the calls the profiler did
            # not slow: those after the traced stretch
            run.spans.ns.clear()
        done = (time.perf_counter() - t0 >= seconds and prof is None
                and (not trace or i > trace_hi))
        if done or failed >= MAX_FAILED:
            break
    run.window_s = time.perf_counter() - t0
    out = None
    peak = torch.cuda.max_memory_allocated(dev) if gpu else 0
    per_call = {c: (_read_counter(c) - before[c]) / max(len(run.calls), 1)
                for c in counters}

    # -- the check, once the program's state is freed ---------------------
    if last is not None and all(last[1] is not k[1] for k in kept):
        kept.append(last)
    del entry, last
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    readings = (check(cfg, pool, kept, dev, len(run.request_shape) == 1, here)
                if kept else {})
    limits = cfg.get("limits", {})
    correct = (failed == 0 and bool(kept) and set(readings) >= set(limits)
               and all(readings[k] <= v for k, v in limits.items()))

    # -- the metrics ------------------------------------------------------
    chosen = parts["per_layer"] if trace else parts["end_to_end"]
    metrics = {}
    for m in chosen:
        value = module("metrics", m["name"], here).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if gpu else dev.type, "kind": kind,
                         "count": parts["cell"]["chips"],
                         "memory_peak_bytes": peak}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    for c, v in per_call.items():
        log(f"counter {c} per call: {v}")
    log(f"memory_peak_bytes {peak}; calls {len(run.calls)}; kept for the "
        f"check {len(kept)}; setup_s {run.setup_s}")
    result["check"] = {k: {"value": readings.get(k), "limit": v}
                       for k, v in limits.items()}
    for k, v in readings.items():
        if k not in limits:
            result["check"][k] = {"value": v, "limit": None}
    for k, v in result["check"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    return result


def _read_trace(prof) -> Trace:
    """The profiler's trace, read through a temporary file that is then
    deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_file(path)
    finally:
        os.unlink(path)


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
