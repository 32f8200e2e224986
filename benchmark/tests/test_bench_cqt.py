"""The CQT cell ``cqt.corpus``: its parts found by name, the readers of its
three per-layer metrics on a hand-built trace, and a traced CPU run of the
cell cut to a size the CPU holds."""

import json
import shutil
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, peaks
from benchmark.harness import load_json, module
from benchmark.tests.conftest import ROOT
from benchmark.trace import Trace

CARD = "NVIDIA H100 80GB HBM3"
CELL = "cqt.corpus"
READERS = ["cqt_roofline", "resample_ms.cqt", "torch_code_ms.cqt"]
SHARED = ["audio_hours_per_s", "device_idle", "launches_per_call",
          "host_syncs_per_call", "idle_in_program"]


def cfg():
    return load_json(ROOT / "benchmark" / "configs" / "cqt_chroma_32k.json")


def test_cell_parts_load_by_name():
    bench = harness.load_benchmark()
    parts = harness.cell_parts(bench, CELL)
    assert parts["cell"]["chips"] == 1
    assert parts["config"]["name"] == "cqt_chroma_32k"
    assert parts["workload"]["config"] == "cqt_chroma_32k"
    names = {m["name"] for m in parts["end_to_end"] + parts["per_layer"]}
    assert names >= set(SHARED) | set(READERS) | {"setup_s"}
    # no kernel span in the CQT's call, so kernel_ms would read None
    assert "kernel_ms" not in names
    lists = {m["name"]: m.get("workloads") for m in
             bench["end_to_end"] + bench["per_layer"]}
    assert all(CELL in lists[name] for name in SHARED + READERS)
    for kind, name in (("entries", "cqt_chroma"),
                       ("reference", "cqt_chroma_32k"),
                       ("counts", "cqt_chroma_32k"),
                       *(("metrics", r) for r in READERS)):
        assert module(kind, name) is not None


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def two_calls(resample=True):
    """Two calls in the window 0-2000 us.  In each, the harness's ``cqt``
    span holds the program's ``af.CQT.cqt``, and inside it six resampler
    spans that launch an operation of 20 us each and six octaves that
    launch one of 50 us each; the harness's ``chroma`` span holds
    ``af.CQT.chroma``, which launches one of 30 us."""
    ev = [_x("bench.window", "user_annotation", 0, 2000)]
    corr = 0

    def launch(when, name, start, dur):
        nonlocal corr
        corr += 1
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", when, 1,
                     correlation=corr))
        ev.append(_x(name, "kernel", start, dur, tid=7, correlation=corr))

    for base in (0, 1000):
        ev += [_x("bench.call", "user_annotation", base, 900),
               _x("bench.cqt", "user_annotation", base, 800),
               _x("af.CQT.cqt", "user_annotation", base + 1, 790)]
        for k in range(6):
            at = base + 10 + 120 * k
            launch(at + 1, "octave_op", at + 2, 50)
            if resample:
                ev.append(_x("af.Resample.resample", "user_annotation",
                             at + 60, 50))
            launch(at + 61, "resample_op", at + 70, 20)
        ev += [_x("bench.chroma", "user_annotation", base + 810, 80),
               _x("af.CQT.chroma", "user_annotation", base + 811, 70)]
        launch(base + 812, "chroma_op", base + 815, 30)
    return ev


def run_of(events, rows=128, n=960_000):
    return SimpleNamespace(trace=Trace(events), device_name=CARD,
                           request_shape=(rows, n), cfg=cfg(),
                           counts=lambda: module("counts", "cqt_chroma_32k"))


def test_roofline_on_a_hand_built_trace():
    need = module("counts", "cqt_chroma_32k").cqt_need(cfg(), 128, 960_000)
    got = module("metrics", "cqt_roofline").read(run_of(two_calls()))
    # the CQT's bound over its 6 x (50 + 20) us of device time a call
    assert got == pytest.approx(100 * peaks.bound_s(CARD, *need) / 420e-6)


def test_resample_and_torch_code_on_a_hand_built_trace():
    run = run_of(two_calls())
    assert module("metrics", "resample_ms.cqt").read(run) == pytest.approx(
        6 * 0.020)
    assert module("metrics", "torch_code_ms.cqt").read(run) == pytest.approx(
        6 * 0.070 + 0.030)


def test_resample_reads_none_without_its_spans():
    """A program that opens no resampler span reads nothing there, and
    does not raise."""
    run = run_of(two_calls(resample=False))
    assert module("metrics", "resample_ms.cqt").read(run) is None
    assert module("metrics", "torch_code_ms.cqt").read(run) is not None


def test_readers_without_a_trace_read_nothing():
    none = run_of(two_calls())
    none.trace = None
    for reader in READERS:
        assert module("metrics", reader).read(none) is None


@pytest.fixture
def tiny_cqt(tmp_path):
    """A copy of the benchmark's folder with the CQT cell cut to 2 clips
    of 1 s."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    path = here / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl.update(batch=2, samples=32000, pool=1, keep=1, trace_calls=2)
    path.write_text(json.dumps(wl))
    return json.loads((ROOT / "BENCHMARK.json").read_text()), here


def test_traced_cpu_run_reads_numbers_or_none(tiny_cqt):
    bench, here = tiny_cqt
    logged = []
    res = harness.run_cell(bench, CELL, 2**31 + 37, 0.2, True, time.time(),
                           device="cpu", here=here, log=logged.append)
    assert res["correct"], res["check"]
    assert set(res["check"]) == set(cfg()["limits"])
    assert ("counter audioflux_torch.ops.fft:rfft.library_calls per call: "
            "7.0") in logged
    for m in harness.cell_parts(bench, CELL, here)["per_layer"]:
        got = res["metrics"].get(m["name"])
        assert got is None or isinstance(got["value"], float)
