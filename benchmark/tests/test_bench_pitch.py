"""The pitch cell ``pitch.corpus``: its parts found by name, the readers of
its five per-layer metrics on a hand-built trace, and a traced CPU run of
the cell cut to a size the CPU holds."""

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
CELL = "pitch.corpus"
STAGES = ("ncf", "hps", "pef", "hr")
READERS = [f"{s}_roofline" for s in STAGES] + ["torch_code_ms.pitch"]
SHARED = ["audio_hours_per_s", "device_idle", "kernel_ms",
          "launches_per_call", "host_syncs_per_call", "idle_in_program"]


def cfg():
    return load_json(ROOT / "benchmark" / "configs" / "pitch_track_32k.json")


def test_cell_parts_load_by_name():
    bench = harness.load_benchmark()
    parts = harness.cell_parts(bench, CELL)
    assert parts["cell"]["chips"] == 1
    assert parts["config"]["name"] == "pitch_track_32k"
    assert parts["workload"]["config"] == "pitch_track_32k"
    names = {m["name"] for m in parts["end_to_end"] + parts["per_layer"]}
    assert names >= set(SHARED) | set(READERS) | {"setup_s"}
    lists = {m["name"]: m.get("workloads") for m in
             bench["end_to_end"] + bench["per_layer"]}
    assert all(CELL in lists[name] for name in SHARED + READERS)
    for kind, name in (("entries", "pitch_track"),
                       ("reference", "pitch_track_32k"),
                       ("counts", "pitch_track_32k"),
                       *(("metrics", r) for r in READERS)):
        assert module(kind, name) is not None


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def two_calls():
    """Two calls in the window 0-2000 us.  In each, the harness's span of
    every stage (200 us apart) holds the program's entry span, inside it a
    kernel span whose kernel runs 100 us, and beside it a PyTorch
    operation of 10 us."""
    ev = [_x("bench.window", "user_annotation", 0, 2000)]
    corr = 0
    for base in (0, 1000):
        ev.append(_x("bench.call", "user_annotation", base, 900))
        for k, stage in enumerate(STAGES):
            at = base + 200 * k

            def launch(when, name, start, dur):
                nonlocal corr
                corr += 1
                ev.append(_x("cudaLaunchKernel", "cuda_runtime", when, 1,
                             correlation=corr))
                ev.append(_x(name, "kernel", start, dur, tid=7,
                             correlation=corr))
            ev += [_x(f"bench.{stage}", "user_annotation", at, 190),
                   _x(f"af.{stage}", "user_annotation", at + 1, 180),
                   _x("af.kernel.fft_fwd", "user_annotation", at + 5, 5)]
            launch(at + 6, f"{stage}_kernel", at + 10, 100)
            launch(at + 20, "torch_op", at + 120, 10)
    return ev


def run_of(events, rows=8, n=9_600_000):
    return SimpleNamespace(trace=Trace(events), device_name=CARD,
                           request_shape=(rows, n), cfg=cfg(),
                           counts=lambda: module("counts", "pitch_track_32k"))


@pytest.mark.parametrize("stage", STAGES)
def test_rooflines_on_a_hand_built_trace(stage):
    counts = module("counts", "pitch_track_32k")
    need = getattr(counts, f"{stage}_need")(cfg(), 8, 9_600_000)
    got = module("metrics", f"{stage}_roofline").read(run_of(two_calls()))
    # the stage's bound over its 110 us of device time a call
    assert got == pytest.approx(100 * peaks.bound_s(CARD, *need) / 110e-6)


def test_torch_code_on_a_hand_built_trace():
    got = module("metrics", "torch_code_ms.pitch").read(run_of(two_calls()))
    assert got == pytest.approx(4 * 0.010)


def test_readers_without_a_trace_read_nothing():
    none = run_of(two_calls())
    none.trace = None
    for reader in READERS:
        assert module("metrics", reader).read(none) is None


@pytest.fixture
def tiny_pitch(tmp_path):
    """A copy of the benchmark's folder with the pitch cell cut to 2
    recordings of 2 s."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    path = here / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl.update(batch=2, samples=64000, pool=1, keep=1, trace_calls=2)
    path.write_text(json.dumps(wl))
    return json.loads((ROOT / "BENCHMARK.json").read_text()), here


def test_traced_cpu_run_reads_numbers_or_none(tiny_pitch):
    bench, here = tiny_pitch
    res = harness.run_cell(bench, CELL, 2**31 + 31, 0.2, True, time.time(),
                           device="cpu", here=here, log=lambda s: None)
    assert res["correct"], res["check"]
    assert set(res["check"]) == set(cfg()["limits"])
    for m in harness.cell_parts(bench, CELL, here)["per_layer"]:
        got = res["metrics"].get(m["name"])
        assert got is None or isinstance(got["value"], float)
