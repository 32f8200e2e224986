"""Seconds of the set-up in the program's native seam: the union of its
``af.setup.load.``, ``af.setup.build.`` and ``af.setup.launch.`` spans
(each library's hash, build and dlopen, each C entry's first launch on
the card) before the first timed call (``benchmark/setup_spans.py``)."""

from benchmark.setup_spans import split


def read(run):
    got = split(run)
    return None if got is None else got[0]
