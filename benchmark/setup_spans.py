"""The program's set-up spans, and the three numbers that split a run's
``setup_s`` by them.

The port records each piece of work it does once (``audioflux_torch.
observe.setup``: the package's import, a library's load, build and first
launch, a plan's construction, a cached table's build) as ``(name, parent,
start_ns, end_ns)`` on ``time.perf_counter_ns``, the clock of the
harness's ``run.calls``, and hands the record out through
``observe.setup_spans()``.  Here the set-up is the ``setup_s`` seconds
before the first timed call: the spans that end before that call are
clipped to it and merged, so that a span nested in another counts once.
(The harness stamps ``setup_s`` a collector's pass before the first call,
and the first seconds of a run are Python's and PyTorch's imports, so the
shift cuts no span of the program.)

- native: the union of the ``af.setup.load.``, ``af.setup.build.`` and
  ``af.setup.launch.`` spans;
- program: the union of every other ``af.setup.`` span (the import, the
  plans, the tables), less the native union;
- outside: ``setup_s`` less the union of every ``af.setup.`` span: the
  imports of PyTorch and the harness, the card's context, the pool of
  requests, the warm-up beyond the program's own set-up.

The three sum to ``setup_s``.  :func:`split` returns None where the
program records no set-up spans (it has no ``observe.setup_spans``), where
no call was timed, or where the run has no ``setup_s``.
"""

from __future__ import annotations

from benchmark.trace import clip, union_length

SETUP = "af.setup."
NATIVE = ("af.setup.load.", "af.setup.build.", "af.setup.launch.")


def split(run):
    """(native, program, outside) seconds of ``run.setup_s``, or None."""
    if run.setup_s is None or not run.calls:
        return None
    from audioflux_torch import observe
    setup_spans = getattr(observe, "setup_spans", None)
    if setup_spans is None:
        return None
    hi = run.calls[0][0]
    lo = hi - round(run.setup_s * 1e9)
    kept = [(name, s, e) for name, _, s, e in setup_spans()
            if name.startswith(SETUP) and e <= hi]
    every = union_length(clip([(s, e) for _, s, e in kept], lo, hi)) / 1e9
    native = union_length(clip([(s, e) for name, s, e in kept
                                if name.startswith(NATIVE)], lo, hi)) / 1e9
    return native, every - native, run.setup_s - every
