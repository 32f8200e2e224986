"""The readers of the program's own spans (``program_spans.py``): each of
the five per-layer metrics on a hand-built trace, against the value
reckoned by hand; and on a CPU run of the harness, a number or None."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans
from benchmark.trace import Trace

READERS = ["kernel_ms", "torch_code_ms.mir", "launches_per_call",
           "host_syncs_per_call", "idle_in_program"]


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def two_calls():
    """Two calls in the window 0-200 us.  Call 1 (0-100): program spans
    af.outer (5-70) around af.HPSS.hpss (10-60) around the kernel span
    af.kernel.fft_fwd (20-30), which launches k1 (30-50); inside the
    program spans but outside the kernel span an elementwise kernel
    (50-60), a copy (60-65) and a stream synchronize; outside every program
    span a kernel (85-95) and a synchronize.  Call 2 (100-200): the host's
    af.peak_pick (110-150) with the device idle, then af.kernel.median
    (160-170) launching k5 (170-180)."""
    return [
        _x("bench.window", "user_annotation", 0, 200),
        _x("bench.call", "user_annotation", 0, 100),
        _x("af.outer", "user_annotation", 5, 65),
        _x("af.HPSS.hpss", "user_annotation", 10, 50),
        _x("af.kernel.fft_fwd", "user_annotation", 20, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 25, 1, correlation=1),
        _x("k1", "kernel", 30, 20, tid=7, correlation=1),
        _x("aten::mul", "cpu_op", 39, 3),
        _x("cudaLaunchKernel", "cuda_runtime", 40, 1, correlation=2),
        _x("elementwise", "kernel", 50, 10, tid=7, correlation=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 45, 1, correlation=3),
        _x("Memcpy HtoD", "gpu_memcpy", 60, 5, tid=7, correlation=3),
        _x("cudaStreamSynchronize", "cuda_runtime", 46, 12),
        _x("cudaLaunchKernel", "cuda_runtime", 80, 1, correlation=4),
        _x("outside", "kernel", 85, 10, tid=7, correlation=4),
        _x("cudaStreamSynchronize", "cuda_runtime", 90, 5),
        _x("bench.call", "user_annotation", 100, 100),
        _x("af.peak_pick", "user_annotation", 110, 40),
        _x("af.kernel.median", "user_annotation", 160, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 165, 1, correlation=5),
        _x("k5", "kernel", 170, 10, tid=7, correlation=5),
    ]


def run_of(events):
    return SimpleNamespace(trace=Trace(events))


@pytest.mark.parametrize("reader, want", [
    # k1 20 us + k5 10 us over 2 calls
    ("kernel_ms", 0.015),
    # the elementwise kernel and the copy, 50-65, over 2 calls
    ("torch_code_ms", 0.0075),
    # k1, the elementwise kernel and k5, each once though launched inside
    # nested spans; the copy is no kernel, the kernel at 85 no program's
    ("launches_per_call", 1.5),
    # the synchronize at 46; the one at 90 is the caller's
    ("host_syncs_per_call", 0.5),
    # idle 0-30, 65-85, 95-170, 180-200 against the spans merged to 5-70,
    # 110-150, 160-170: 25 + 5 + 40 + 10 of 200 us
    ("idle_in_program", 0.4),
])
def test_readers_on_a_hand_built_trace(reader, want):
    got = getattr(program_spans, reader)(run_of(two_calls()))
    assert got == pytest.approx(want)


def test_idle_gap_half_inside_a_program_span_counts_half():
    events = [
        _x("bench.window", "user_annotation", 0, 100),
        _x("bench.call", "user_annotation", 0, 100),
        _x("af.kernel.x", "user_annotation", 0, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 1, 1, correlation=1),
        _x("k", "kernel", 2, 8, tid=7, correlation=1),
        _x("af.peak_pick", "user_annotation", 55, 45),
    ]
    # idle 0-2 (inside af.kernel.x) and 10-100, of which 55-100 is inside
    got = program_spans.idle_in_program(run_of(events))
    assert got == pytest.approx((2 + 45) / 100)


def test_a_program_without_spans_reads_nothing():
    events = [e for e in two_calls() if not e["name"].startswith("af.")]
    run = run_of(events)
    for reader in ("kernel_ms", "torch_code_ms", "launches_per_call",
                   "host_syncs_per_call", "idle_in_program"):
        assert getattr(program_spans, reader)(run) is None
    assert program_spans.kernel_ms(SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("cell", ["mel_mfcc.corpus", "mir.corpus"])
def test_traced_cpu_run_reads_numbers_or_none(tiny_bench, cell):
    bench, here = tiny_bench
    names = {m["name"] for m in harness.cell_parts(bench, cell, here)
             ["per_layer"]}
    assert names >= {r for r in READERS
                     if cell == "mir.corpus" or not r.endswith(".mir")}
    res = harness.run_cell(bench, cell, 2**31 + 17, 0.2, True, time.time(),
                           device="cpu", here=here, log=lambda s: None)
    assert res["correct"]
    for name in READERS:
        got = res["metrics"].get(name)
        assert got is None or isinstance(got["value"], float)
