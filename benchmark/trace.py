"""Reading a ``torch.profiler`` Chrome trace into the numbers the per-layer
metrics need.

- Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events.  Each carries the correlation id of the host call
  that launched it (``cuda_runtime`` or ``cuda_driver`` events).
- The harness marks its own spans with ``torch.profiler.record_function``
  (``user_annotation`` events named ``bench.<span>``); the stretch it
  traced is ``bench.window``.
- Busy time is the union of the device operations' intervals inside the
  window, so overlapping operations count once; idle is the rest.
- An operation was launched inside a span when its launch lies inside one
  of the span's intervals on the same thread.  Where the trace holds no
  launch event for an operation, an operation that ran inside the span's
  interval counts, which is the same thing for calls that wait for their
  results before they return.
- An operation was launched under PyTorch code when its launch lies inside
  a ``cpu_op`` named ``aten::...``; the program's own kernels are launched
  through ctypes, outside any such operator.
"""

from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_WIDTH = 120


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Trace:
    def __init__(self, events: list):
        self.device = []          # (start_s, end_s, name, cat, correlation)
        self.launch = {}          # correlation -> (thread, ts_s)
        self.spans = defaultdict(lambda: defaultdict(list))  # name -> thread -> [(s, e)]
        self.host = defaultdict(list)                         # thread -> [(s, e, name)]
        self.aten = defaultdict(list)                         # thread -> [(s, e)]
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev.get("dur", 0.0)) * 1e-6
            args = ev.get("args") or {}
            thread = (ev.get("pid"), ev.get("tid"))
            if cat in DEVICE_CATS:
                self.device.append((s, e, name, cat, args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    self.launch[args["correlation"]] = (thread, s)
                self.host[thread].append((s, e, name))
            elif cat == "user_annotation":
                self.spans[name][thread].append((s, e))
                self.host[thread].append((s, e, name))
            elif cat == "cpu_op":
                if name.startswith("aten::"):
                    self.aten[thread].append((s, e))
                self.host[thread].append((s, e, name))
        self.device.sort()
        for iv in self.host.values():
            iv.sort()
        for thread in self.aten:
            self.aten[thread].sort()
        win = [iv for per in self.spans.get("bench.window", {}).values()
               for iv in per]
        if win:
            self.lo, self.hi = min(s for s, _ in win), max(e for _, e in win)
        elif self.device:
            self.lo = self.device[0][0]
            self.hi = max(e for _, e, *_ in self.device)
        else:
            self.lo = self.hi = 0.0

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("traceEvents", data) if isinstance(data, dict)
                   else data)

    # -- the window ------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_intervals(self, ops=None):
        ops = self.device if ops is None else ops
        return clip([(s, e) for s, e, *_ in ops], self.lo, self.hi)

    @property
    def busy_s(self) -> float:
        return union_length(self.busy_intervals())

    def idle_share(self):
        if self.window_s <= 0 or not self.device:
            return None
        return 1.0 - self.busy_s / self.window_s

    # -- spans -----------------------------------------------------------
    def span_intervals(self, name: str):
        """All intervals of the annotation ``name`` inside the window."""
        out = [iv for per in self.spans.get(name, {}).values() for iv in per]
        return sorted(clip(out, self.lo, self.hi))

    def _inside(self, intervals_by_thread, thread, t) -> bool:
        ivs = intervals_by_thread.get(thread, [])
        i = bisect.bisect_right(ivs, (t, float("inf")))
        return any(s <= t <= e for s, e in ivs[max(0, i - 64):i])

    def launched_in(self, name: str):
        """Device operations launched inside the annotation ``name``."""
        by_thread = {th: sorted(ivs) for th, ivs
                     in self.spans.get(name, {}).items()}
        spans = sorted(iv for ivs in by_thread.values() for iv in ivs)
        out = []
        for op in self.device:
            where = self.launch.get(op[4])
            if where is not None:
                if self._inside(by_thread, where[0], where[1]):
                    out.append(op)
            elif _holds(spans, op[0], op[1]):
                out.append(op)
        return out

    def under_aten(self, op) -> bool:
        """Whether the operation's launch lies inside an ``aten::`` op."""
        where = self.launch.get(op[4])
        return where is not None and self._inside(self.aten, where[0],
                                                  where[1])

    # -- the breakdown ---------------------------------------------------
    def gaps(self):
        """Idle (start, end) stretches of the device inside the window."""
        out, t = [], self.lo
        for s, e in sorted(self.busy_intervals()):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def host_activity(self, times) -> list:
        """For each of the sorted ``times``, what the host was doing: the
        innermost harness span and the innermost operator or runtime call
        inside it, on the thread with the deepest nesting at that time."""
        best = [[] for _ in times]
        for events in self.host.values():
            i, active = 0, []
            for k, t in enumerate(times):
                while i < len(events) and events[i][0] <= t:
                    heapq.heappush(active, (events[i][1], events[i]))
                    i += 1
                while active and active[0][0] < t:
                    heapq.heappop(active)
                if len(active) > len(best[k]):
                    best[k] = [ev for _, ev in active]
        return [_activity_name(held) for held in best]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time inside the
        window, by name, and the device's idle time by what the host was
        doing during it; ``top`` of each, longest first, in seconds."""
        ops = defaultdict(float)
        for s, e, name, _, _ in self.device:
            s, e = max(s, self.lo), min(e, self.hi)
            if e > s:
                ops[name[:NAME_WIDTH]] += e - s
        idle = defaultdict(float)
        found = self.gaps()
        names = self.host_activity([0.5 * (s + e) for s, e in found])
        for (s, e), name in zip(found, names):
            idle[name] += e - s
        rank = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def _activity_name(held) -> str:
    if not held:
        return "no host span"
    held = sorted(held, key=lambda ev: ev[1] - ev[0])
    span = next((n for _, _, n in held if n.startswith("bench.")
                 and n != "bench.window"), None)
    inner = held[0][2]
    if inner == "bench.window":
        return "between calls"
    name = inner if span in (None, inner) else f"{span} > {inner}"
    return name[:NAME_WIDTH]


def _holds(spans, s, e) -> bool:
    i = bisect.bisect_right(spans, (s, float("inf")))
    return any(a <= s and e <= b for a, b in spans[max(0, i - 64):i])
