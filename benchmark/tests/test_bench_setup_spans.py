"""The three readers that split ``setup_s`` by the program's set-up spans
(``benchmark/setup_spans.py``): on hand-built records against the values
reckoned by hand, None where there is nothing to read, and on a traced CPU
run of the harness, three numbers that sum to the run's ``setup_s``."""

import time
from types import SimpleNamespace

import pytest

from audioflux_torch import observe
from benchmark import harness
from benchmark.harness import module

READERS = ["setup_native_s", "setup_program_s", "setup_outside_s"]
CELLS = ["mel_mfcc.corpus", "mir.corpus", "wavelet.corpus", "pitch.corpus",
         "cqt.corpus"]
S = 10**9

# a run whose set-up took 10 s and whose first call starts at 20 s: the
# set-up is 10-20 s on the spans' clock
FIRST_CALL = 20 * S
SETUP_S = 10.0


def _span(name, start, end, parent=None):
    return (name, parent, round(start * S), round(end * S))


RECORDS = {
    # import 11-12; a plan 13-15 holding a table; a load 14-16.5 over the
    # plan's end, holding its build; a launch 17-17.5.  Native: 14-16.5
    # and 17-17.5 = 3.0; every span: 11-12, 13-16.5, 17-17.5 = 5.0
    "nested and overlapping": (
        [_span("af.setup.import", 11, 12),
         _span("af.setup.table.m.f", 13.5, 14, "af.setup.plan.X"),
         _span("af.setup.build.lib", 14.5, 16, "af.setup.load.lib"),
         _span("af.setup.plan.X", 13, 15),
         _span("af.setup.load.lib", 14, 16.5),
         _span("af.setup.launch.k", 17, 17.5)],
        (3.0, 2.0, 5.0)),
    # a plan built after the first call's start, and one of an earlier
    # run of the process, wholly before the set-up: neither counts; one
    # that straddles the set-up's start counts from it
    "after the first call or before the set-up": (
        [_span("af.setup.plan.Late", 19.5, 20.5),
         _span("af.setup.launch.late", 21, 22),
         _span("af.setup.plan.Early", 5, 6),
         _span("af.setup.table.m.g", 9.5, 10.5)],
        (0.0, 0.5, 9.5)),
    # a span the program opened outside the set-up's names reads nothing
    "no set-up span": ([("af.HPSS.hpss", None, 12 * S, 13 * S)],
                       (0.0, 0.0, 10.0)),
}


def _run(setup_s=SETUP_S, calls=((FIRST_CALL, FIRST_CALL + S, True),)):
    return SimpleNamespace(setup_s=setup_s, calls=list(calls))


def _read(run):
    return tuple(module("metrics", r).read(run) for r in READERS)


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_readers_on_hand_built_records(case, monkeypatch):
    spans, want = RECORDS[case]
    monkeypatch.setattr(observe, "setup_spans", lambda: list(spans))
    got = _read(_run())
    assert got == pytest.approx(want, abs=1e-9)
    assert sum(got) == pytest.approx(SETUP_S, abs=1e-9)
    assert all(v >= 0 for v in got)


@pytest.mark.parametrize("case", ["the parent: no setup_spans",
                                  "no timed call", "no setup_s"])
def test_readers_read_none_where_there_is_nothing(case, monkeypatch):
    run = _run()
    if case == "the parent: no setup_spans":
        monkeypatch.delattr(observe, "setup_spans")
    elif case == "no timed call":
        run.calls = []
    else:
        run.setup_s = None
    assert _read(run) == (None, None, None)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_lists_the_three_readers(cell):
    bench = harness.load_benchmark()
    metrics = {m["name"]: m for m in harness.cell_parts(bench, cell)
               ["per_layer"]}
    for name in READERS:
        assert metrics[name]["moves"] == "setup_s"
        assert metrics[name]["source"] == "host_clock"


def test_traced_cpu_run_splits_its_setup_s(tiny_bench):
    bench, here = tiny_bench
    logged = []
    # run.py starts the clock before its imports, a second or more before
    # the program's first span; the reader's window is the setup_s before
    # the first call, later than that by the collector's pass
    res = harness.run_cell(bench, "mir.corpus", 2**31 + 23, 0.2, True,
                           time.time() - 1.0, device="cpu", here=here,
                           log=logged.append)
    assert res["correct"]
    setup_s, = [float(line.rsplit("setup_s ", 1)[1]) for line in logged
                if "setup_s " in line]
    got = [res["metrics"][name]["value"] for name in READERS]
    assert all(isinstance(v, float) and v >= 0 for v in got)
    assert sum(got) == pytest.approx(setup_s, abs=1e-6)
    # the entry's plans were built inside the set-up
    assert got[1] > 0
