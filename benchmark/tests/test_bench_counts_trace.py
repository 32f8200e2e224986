"""The counts of a call's work and the trace reader's arithmetic."""

import json

import pytest

from benchmark import peaks
from benchmark.harness import load_json
from benchmark.tests.conftest import ROOT
from benchmark.trace import Trace, union_length


def test_mel_mfcc_headline_bound_is_0_953_ms():
    from benchmark.counts import mel_mfcc_32k
    cfg = load_json(ROOT / "benchmark" / "configs" / "mel_mfcc_32k.json")
    n_bytes, ops = mel_mfcc_32k.need(cfg, 1000, 513536)
    peak = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
    assert ops / peak["fp32_flop_per_s"] > n_bytes / peak["hbm_bytes_per_s"]
    bound_ms = 1e3 * peaks.bound_s("NVIDIA H100 80GB HBM3", n_bytes, ops)
    assert round(bound_ms, 3) == 0.953


def test_hpss_need_counts_three_transforms_a_frame():
    from benchmark.counts import mir_pipeline_32k
    cfg = load_json(ROOT / "benchmark" / "configs" / "mir_pipeline_32k.json")
    n_bytes, ops = mir_pipeline_32k.hpss_need(cfg, 8, 9600000)
    frames = 8 * ((9600000 - 2048) // 512 + 1)
    assert ops == pytest.approx(frames * 3 * 2.5 * 2048 * 11)
    out_n = ((9600000 - 2048) // 512) * 512 + 2048
    assert n_bytes == 4 * (8 * 9600000 + 2 * 8 * out_n)
    assert 1e3 * peaks.bound_s("NVIDIA H100 80GB HBM3", n_bytes, ops) \
        == pytest.approx(0.378, abs=1e-3)


def test_unknown_card_has_no_bound():
    assert peaks.bound_s("some other card", 1.0, 1.0) is None


def test_union_length_counts_overlap_once():
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def synthetic_trace():
    """Two calls inside the window 0-100 us.  Call 1 (0-40): an aten op
    launches kernel k1 (correlation 1), then a ctypes launch of k2 (2).
    Call 2 (50-90): a host stage (55-70) with a copy back (3), then a ctypes
    launch (4); kernel k5 has no launch event and runs inside call 2."""
    return [
        _x("bench.window", "user_annotation", 0, 100),
        _x("bench.call", "user_annotation", 0, 40),
        _x("aten::add", "cpu_op", 1, 4),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=2),
        _x("k1", "kernel", 3, 7, tid=7, correlation=1),
        _x("k2", "kernel", 10, 20, tid=7, correlation=2),
        _x("bench.call", "user_annotation", 50, 40),
        _x("bench.host_stage", "user_annotation", 55, 15),
        _x("cudaMemcpyAsync", "cuda_runtime", 56, 2, correlation=3),
        _x("Memcpy DtoH", "gpu_memcpy", 57, 3, tid=7, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 72, 1, correlation=4),
        _x("k2", "kernel", 73, 10, tid=7, correlation=4),
        _x("k5", "kernel", 84, 2, tid=7),
        _x("outside", "kernel", 120, 50, tid=7, correlation=9),
    ]


def test_trace_busy_idle_and_launches(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": synthetic_trace()}))
    tr = Trace.from_file(path)
    assert tr.window_s == pytest.approx(100e-6)
    # k1 3-10, k2 10-30, copy 57-60, k2 73-83, k5 84-86: 42 us busy
    assert tr.busy_s == pytest.approx(42e-6)
    assert tr.idle_share() == pytest.approx(0.58)
    names = sorted(op[2] for op in tr.launched_in("bench.call"))
    assert names == ["Memcpy DtoH", "k1", "k2", "k2", "k5"]
    assert [op[2] for op in tr.launched_in("bench.host_stage")] == ["Memcpy DtoH"]
    aten = [op[2] for op in tr.device if tr.under_aten(op)]
    assert aten == ["k1"]


def test_trace_breakdown_names_ops_and_idle_host_activity():
    tr = Trace(synthetic_trace())
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "k2"
    assert b["device_ops"][0][1] == pytest.approx(30e-6)
    idle = dict(b["idle_gaps"])
    # each gap goes to what the host did at its middle: 60-73 to the host
    # stage, 30-57 and 86-100 to the harness between calls
    assert idle["bench.host_stage"] == pytest.approx(13e-6)
    assert idle["between calls"] == pytest.approx(41e-6)
    assert idle["bench.call > aten::add"] == pytest.approx(3e-6)
    assert sum(idle.values()) == pytest.approx(58e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
