"""Median host-clock ms a call spends on the host stage: from the
envelope in host memory to the last peak-pick's return (the fetch before
it, which waits for the card, is the span ``fetch``)."""

from benchmark.readers import median_span


def read(run):
    return median_span(run, "host_stage", 1e6)
