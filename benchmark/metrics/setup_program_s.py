"""Seconds of the set-up in the program's other set-up spans: the union
of the ``af.setup.`` spans that are not the native seam's (the package's
import, the plans, the cached tables), less the native union
(``benchmark/setup_spans.py``)."""

from benchmark.setup_spans import split


def read(run):
    got = split(run)
    return None if got is None else got[1]
