"""Arithmetic the metric readers share."""

from __future__ import annotations

import math

from benchmark import peaks
from benchmark.trace import union_length


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100)."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def median_span(run, name: str, scale: float):
    ns = run.spans.ns.get(name)
    return percentile(ns, 50) / scale if ns else None


def roofline_pct(run, span: str, need):
    """Percent of the card's peak that the bound of ``need`` = (bytes,
    operations) a call takes of the device busy time launched inside the
    traced calls' ``span``."""
    tr = run.trace
    if tr is None:
        return None
    busy = union_length(tr.busy_intervals(tr.launched_in("bench." + span)))
    calls = len(tr.span_intervals("bench." + span))
    bound = peaks.bound_s(run.device_name, *need)
    if busy <= 0 or not calls or bound is None:
        return None
    return 100.0 * bound * calls / busy
