"""The wavelet cell ``wavelet.corpus``: the readers of its three per-layer
metrics on a hand-built trace, its counts, its entry and plain reference
on the CPU at a small size, and a traced CPU run of the cell cut to a size
the CPU holds."""

import contextlib
import json
import shutil
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, peaks, traffic
from benchmark.harness import load_json, module
from benchmark.tests.conftest import ROOT
from benchmark.trace import Trace

CARD = "NVIDIA H100 80GB HBM3"
CELL = "wavelet.corpus"
READERS = ["cwt_roofline", "synsq_roofline", "torch_code_ms.wavelet"]


def cfg(radix2_exp=None):
    c = load_json(ROOT / "benchmark" / "configs" / "cwt_synsq_32k.json")
    if radix2_exp is not None:
        for plan in c["plans"].values():
            plan["radix2_exp"] = radix2_exp
    return c


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def two_calls():
    """Two wavelet calls in the window 0-2000 us.  Each: the harness's
    ``bench.cwt`` around ``af.CWT.cwt``, which launches a PyTorch copy (20
    us) and, inside ``af.kernel.cwt_ifft_bank``, the kernel (400 us); then
    ``bench.synsq`` around ``af.Synsq.synsq``, whose two kernel spans launch
    100 and 200 us of kernels, beside a PyTorch operation of 10 us."""
    ev = [_x("bench.window", "user_annotation", 0, 2000)]
    corr = 0
    for base in (0, 1000):
        def launch(at, name, start, dur):
            nonlocal corr
            corr += 1
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", base + at, 1,
                         correlation=corr))
            ev.append(_x(name, "kernel", base + start, dur, tid=7,
                         correlation=corr))
        ev += [_x("bench.call", "user_annotation", base, 900),
               _x("bench.cwt", "user_annotation", base, 450),
               _x("af.CWT.cwt", "user_annotation", base + 1, 440),
               _x("af.kernel.cwt_ifft_bank", "user_annotation", base + 10, 5),
               _x("bench.synsq", "user_annotation", base + 450, 400),
               _x("af.Synsq.synsq", "user_annotation", base + 451, 390),
               _x("af.kernel.synsq_bins", "user_annotation", base + 460, 5),
               _x("af.kernel.columnar_scatter", "user_annotation",
                  base + 470, 5)]
        launch(5, "copy_kernel", 5, 20)
        launch(12, "cwt_kernel", 30, 400)
        launch(462, "bins_kernel", 460, 100)
        launch(472, "scatter_kernel", 560, 200)
        launch(480, "torch_op", 760, 10)
    return ev


def run_of(events, rows=256, n=32768):
    return SimpleNamespace(trace=Trace(events), device_name=CARD,
                           request_shape=(rows, n), cfg=cfg(),
                           counts=lambda: module("counts", "cwt_synsq_32k"))


@pytest.mark.parametrize("reader, want", [
    # the CWT's bytes bound, 1.6993 ms, over its 420 us of device time
    ("cwt_roofline", 100 * 1.6993191355223882e-3 / 420e-6),
    # the squeeze's bytes bound, 3.3655 ms, over its 310 us
    ("synsq_roofline", 100 * 3.3654594483582088e-3 / 310e-6),
    # the copy (20 us) and the PyTorch operation (10 us), a call
    ("torch_code_ms.wavelet", 0.030),
])
def test_readers_on_a_hand_built_trace(reader, want):
    got = module("metrics", reader).read(run_of(two_calls()))
    assert got == pytest.approx(want)


def test_readers_without_a_trace_or_a_card_read_nothing():
    none = run_of(two_calls())
    none.trace = None
    for reader in READERS:
        assert module("metrics", reader).read(none) is None
    other = run_of(two_calls())
    other.device_name = "some other card"
    assert module("metrics", "cwt_roofline").read(other) is None


def test_cwt_bytes_bound_exceeds_its_operations_bound():
    from benchmark.counts import cwt_synsq_32k as counts
    n_bytes, ops = counts.cwt_need(cfg(), 256, 32768)
    assert n_bytes == 4 * 256 * 32768 + 8 * 256 * 84 * 32768 + 4 * 84 * 65536
    assert ops == 256 * (2.5 + 84 * 5) * 65536 * 16
    peak = peaks.PEAKS[CARD]
    assert n_bytes / peak["hbm_bytes_per_s"] > ops / peak["fp32_flop_per_s"]
    assert 1e3 * peaks.bound_s(CARD, n_bytes, ops) == pytest.approx(1.699,
                                                                    abs=1e-3)
    assert counts.synsq_need(cfg(), 256, 32768) == (16 * 256 * 84 * 32768, 0.0)


def test_entry_and_reference_agree_on_the_cpu():
    c = cfg(radix2_exp=14)
    ref = module("reference", "cwt_synsq_32k")
    entry = module("entries", "cwt_synsq").Entry(c, "cpu")
    x = traffic.mir((2, 1 << 14), traffic.generator(2**31 + 3, "cpu"), "cpu",
                    32000)

    class Spans:
        def span(self, name):
            return contextlib.nullcontext()
    got = entry.call(x, Spans())
    assert got["cwt"].shape == got["synsq"].shape == (2, 84, 1 << 14)
    want = ref.Reference(c, "cpu").run(x)
    assert want["cwt"].shape == (2, 84, 1 << 14, 2)
    readings = ref.compare(got, want)
    limits = c["limits"]
    assert set(readings) == set(limits)
    assert all(readings[k] <= limits[k] for k in limits), readings


@pytest.fixture
def tiny_wavelet(tmp_path):
    """A copy of the benchmark's folder with the wavelet cell cut to 2
    clips of 2^14 samples (its configuration too)."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (here / "configs" / "cwt_synsq_32k.json").write_text(
        json.dumps(cfg(radix2_exp=14)))
    path = here / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl.update(batch=2, samples=1 << 14, pool=1, keep=1, trace_calls=2)
    path.write_text(json.dumps(wl))
    return json.loads((ROOT / "BENCHMARK.json").read_text()), here


def test_traced_cpu_run_reads_numbers_or_none(tiny_wavelet):
    bench, here = tiny_wavelet
    names = {m["name"] for m in harness.cell_parts(bench, CELL, here)
             ["per_layer"]}
    assert names >= set(READERS) | {"kernel_ms", "launches_per_call",
                                    "device_idle"}
    res = harness.run_cell(bench, CELL, 2**31 + 29, 0.2, True, time.time(),
                           device="cpu", here=here, log=lambda s: None)
    assert res["correct"], res["check"]
    for name in names:
        got = res["metrics"].get(name)
        assert got is None or isinstance(got["value"], float)
