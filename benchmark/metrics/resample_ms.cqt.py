"""Device busy time (union) of the operations launched inside the
program's resampler spans (``af.Resample.resample``: the CQT's 2:1
octave chain, six a call), ms a traced call.  None where the trace holds
no device operation or no such span."""

from benchmark.program_spans import ProgramSpans
from benchmark.trace import union_length

PREFIX = "af.Resample."


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    spans = ProgramSpans(tr, PREFIX)
    calls = len(tr.span_intervals("bench.call"))
    if not spans or not calls:
        return None
    ops = [op for op in tr.device if spans.holds_launch(op)]
    return 1e3 * union_length(tr.busy_intervals(ops)) / calls
