"""The program's own spans in a traced stretch, and the per-layer numbers
read from them.

The port opens a span (``audioflux_torch.observe.scope``, a
``user_annotation`` event while the profiler records) around each entry
call, ``af.<Class>.<method>``, and around each kernel wrapper,
``af.kernel.<wrapper>``.  Here a program span is any annotation whose name
starts with ``af.``, and a kernel span one that starts with
``af.kernel.``.  Spans nest, so each thread's spans are merged into one
set of intervals before anything is tested against them: an operation
launched inside two nested spans counts once.

Every reader returns None where the trace holds no device operation (a
run on the CPU) or no program span (a program that opens none), and a
per-call number over the traced calls (``bench.call`` spans) otherwise.
"""

from __future__ import annotations

import bisect

from benchmark.trace import clip, union_length

PROGRAM = "af."
KERNEL = "af.kernel."
# host calls that wait for the device: each pageable upload, ``.cpu()`` or
# ``.item()`` the program makes ends in one of these
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def merged(intervals) -> list:
    """Sorted, disjoint (start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _inside(ivs, t, end=None) -> bool:
    """Whether ``t`` (and ``end``, if given) lies in one of the sorted,
    disjoint intervals ``ivs``."""
    end = t if end is None else end
    i = bisect.bisect_right(ivs, (t, float("inf")))
    return i > 0 and ivs[i - 1][0] <= t and end <= ivs[i - 1][1]


class ProgramSpans:
    """The traced stretch's program spans, by thread, merged."""

    def __init__(self, trace, prefix: str = PROGRAM):
        self.trace = trace
        by_thread = {}
        for name, per in trace.spans.items():
            if name.startswith(prefix):
                for thread, ivs in per.items():
                    by_thread.setdefault(thread, []).extend(ivs)
        self.by_thread = {th: merged(ivs) for th, ivs in by_thread.items()}
        self.all = merged(iv for ivs in self.by_thread.values()
                          for iv in ivs)

    def __bool__(self) -> bool:
        return bool(self.all)

    def holds_launch(self, op) -> bool:
        """Whether the device operation ``op`` was launched inside a span:
        its launch on the span's thread, or, where the trace holds no
        launch event for it, the operation itself inside a span."""
        where = self.trace.launch.get(op[4])
        if where is not None:
            return _inside(self.by_thread.get(where[0], []), where[1])
        return _inside(self.all, op[0], op[1])

    def holds_host(self, thread, t) -> bool:
        return _inside(self.by_thread.get(thread, []), t)


def _parts(run):
    """(trace, program spans, kernel spans, traced calls), or None where
    there is nothing to read."""
    tr = run.trace
    if tr is None or not tr.device:
        return None
    program = ProgramSpans(tr)
    calls = len(tr.span_intervals("bench.call"))
    if not program or not calls:
        return None
    return tr, program, ProgramSpans(tr, KERNEL), calls


def _busy_ms(tr, ops, calls) -> float:
    return 1e3 * union_length(tr.busy_intervals(ops)) / calls


def kernel_ms(run):
    """Device busy time (union) of the ``kernel`` operations launched
    inside a kernel span, ms a traced call."""
    got = _parts(run)
    if got is None:
        return None
    tr, _, kernels, calls = got
    if not kernels:
        return None
    ops = [op for op in tr.device if op[3] == "kernel"
           and kernels.holds_launch(op)]
    return _busy_ms(tr, ops, calls)


def torch_code_ms(run):
    """Device busy time (union) of the operations launched inside a
    program span and outside every kernel span: PyTorch code the program
    runs between its kernels, ms a traced call."""
    got = _parts(run)
    if got is None:
        return None
    tr, program, kernels, calls = got
    ops = [op for op in tr.device if program.holds_launch(op)
           and not (kernels and kernels.holds_launch(op))]
    return _busy_ms(tr, ops, calls)


def launches_per_call(run):
    """``kernel`` operations launched inside program spans, the program's
    own kernels and PyTorch's, a traced call."""
    got = _parts(run)
    if got is None:
        return None
    tr, program, _, calls = got
    lo, hi = tr.lo, tr.hi
    n = sum(1 for op in tr.device if op[3] == "kernel"
            and lo <= op[0] <= hi and program.holds_launch(op))
    return n / calls


def host_syncs_per_call(run):
    """Host calls that wait for the device (:data:`SYNCS`) made inside
    program spans, a traced call."""
    got = _parts(run)
    if got is None:
        return None
    tr, program, _, calls = got
    n = sum(1 for thread, events in tr.host.items()
            for s, _, name in events
            if name in SYNCS and tr.lo <= s <= tr.hi
            and program.holds_host(thread, s))
    return n / calls


def idle_in_program(run):
    """The traced window's device-idle time that falls inside program
    spans (any thread's), over the window: the idle the program's own host
    code holds, apart from the caller's loop."""
    got = _parts(run)
    if got is None or got[0].window_s <= 0:
        return None
    tr, program, _, _ = got
    spans = clip(program.all, tr.lo, tr.hi)
    idle = 0.0
    for s, e in tr.gaps():
        i = max(0, bisect.bisect_right(spans, (s, float("inf"))) - 1)
        while i < len(spans) and spans[i][0] < e:
            a, b = spans[i]
            idle += max(0.0, min(b, e) - max(a, s))
            i += 1
    return idle / tr.window_s
