"""Seconds of the set-up outside every set-up span of the program:
``setup_s`` less the union of the ``af.setup.`` spans (PyTorch's and the
harness's imports, the card's context, the pool, the warm-up beyond the
program's own set-up; ``benchmark/setup_spans.py``)."""

from benchmark.setup_spans import split


def read(run):
    got = split(run)
    return None if got is None else got[2]
