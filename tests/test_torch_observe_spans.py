"""The port's spans (``audioflux_torch.observe.scope``): while a profiler
records, each entry call the benchmark's cells make and each kernel
wrapper is one ``user_annotation`` event in the exported trace, the
wrappers' nested by time inside the entries'; while none records, no
``record_function`` is entered at all.  On the CPU the wrappers take their
plain versions, under the same spans."""

import contextlib
import gzip
import json
from collections import Counter

import numpy as np
import pytest
import torch

from audioflux_torch import observe
from audioflux_torch.ops import (cuda_cwt, cuda_fft, cuda_median,
                                 cuda_scatter, cuda_unwrap, fused_mel)
from benchmark import harness, traffic

CPU = [torch.profiler.ProfilerActivity.CPU]

# the benchmark's cells at a test's size: (clips, samples) a call
CELLS = {"mel_mfcc.corpus": (3, 2048 + 512 * 7), "mir.corpus": (2, 64000)}

# the entry spans a call of each cell opens, and how often
ENTRY_SPANS = {
    "mel_mfcc.corpus": {"af.MelSpectrogram.spectrogram_mfcc_fused": 1},
    "mir.corpus": {"af.PitchYIN.pitch": 1,
                   "af.MelSpectrogram.spectrogram": 1,
                   "af.Spectral.flux": 1,
                   "af.peak_pick": CELLS["mir.corpus"][0],
                   "af.HPSS.hpss": 1},
}


class _NoCallerSpans:
    def span(self, name):
        return contextlib.nullcontext()


def _cell_call(cell):
    bench = harness.load_benchmark()
    parts = harness.cell_parts(bench, cell)
    wl = dict(parts["workload"], pool=1)
    wl["batch"], wl["samples"] = CELLS[cell]
    x = traffic.make_pool(wl, 2**31 + 5, "cpu")[0]
    entry = harness.build_entry(parts["config"], "cpu")
    return lambda: entry.call(x, _NoCallerSpans())


def _rng(seed=0):
    return torch.Generator().manual_seed(seed)


def _real(*shape, seed=0):
    return torch.randn(shape, generator=_rng(seed))


def _complex(*shape, seed=0):
    return torch.complex(_real(*shape, seed=seed),
                         _real(*shape, seed=seed + 1))


def _fused_mel_mfcc():
    n_fft, num, cc = 512, 8, 4
    plan = fused_mel.FusedMelPlan(
        np.hanning(n_fft), np.abs(_real(num, n_fft // 2 + 1).numpy()),
        _real(cc, num).numpy(), 128, device="cpu")
    return fused_mel.fused_mel_mfcc(plan, _real(2, 2048))


# one call of each kernel wrapper on CPU tensors, by the wrapper's name
KERNELS = {
    "fused_mel_mfcc": _fused_mel_mfcc,
    "fft_fwd": lambda: cuda_fft.fft_fwd(_real(2, 2048)),
    "fft_inv": lambda: cuda_fft.fft_inv(_real(2, 2048),
                                        _real(2, 2048, seed=1)),
    "fft_autocorr": lambda: cuda_fft.fft_autocorr(_real(2, 2048),
                                                  _real(2, 2048, seed=1)),
    "fft_autocorr_frames": lambda: cuda_fft.fft_autocorr_frames(
        _real(3, 100), 4096, 50),
    "fft_autocorr_yin": lambda: cuda_fft.fft_autocorr_yin(
        _real(1, 4096), 2048, 512, 1024),
    "median_filter_last_axis": lambda: cuda_median.median_filter_last_axis(
        _real(4, 50), 5),
    "cwt_ifft_bank": lambda: cuda_cwt.cwt_ifft_bank(
        _complex(1, 16384), _real(2, 16384), pad=0, length=64),
    "unwrap_diff": lambda: cuda_unwrap.unwrap_diff(_real(2, 10)),
    "synsq_bins": lambda: cuda_unwrap.synsq_bins(
        _complex(2, 10), torch.linspace(0.0, 1e4, 8), "linear", 8, 32000.0),
    "columnar_scatter": lambda: cuda_scatter.columnar_scatter(
        _complex(1, 3, 5), torch.randint(-1, 5, (1, 3, 5), generator=_rng(),
                                         dtype=torch.int32), 4),
}

CALLS = ({f"cell:{c}": c for c in CELLS}
         | {f"kernel:{k}": k for k in KERNELS})


def _make(case):
    kind, name = case.split(":")
    return _cell_call(name) if kind == "cell" else KERNELS[name]


def _recorded(fn, tmp_path):
    """The ``af.`` spans of the trace of ``fn()`` under a CPU profiler, as
    (name, start, end) from the exported Chrome trace."""
    with torch.profiler.profile(activities=CPU) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("af.")]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_entry_span_is_recorded_once_a_call(cell, tmp_path):
    spans = _recorded(_cell_call(cell), tmp_path)
    counts = Counter(n for n, _, _ in spans)
    entries = {n: c for n, c in counts.items()
               if not n.startswith("af.kernel.")}
    assert entries == ENTRY_SPANS[cell]
    kernels = [s for s in spans if s[0].startswith("af.kernel.")]
    assert kernels
    outer = [s for s in spans if s[0] in ENTRY_SPANS[cell]]
    for _, s, e in kernels:      # nested by time under an entry's span
        assert any(a <= s and e <= b for _, a, b in outer)
    if cell == "mir.corpus":     # HPSS's two medians
        assert counts["af.kernel.median_filter_last_axis"] == 2


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_each_kernel_wrapper_records_its_span_once(name, tmp_path):
    spans = _recorded(KERNELS[name], tmp_path)
    assert [n for n, _, _ in spans] == [f"af.kernel.{name}"]


@pytest.mark.parametrize("case", sorted(CALLS))
def test_no_profiler_no_record_function(case, monkeypatch):
    fn = _make(case)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    fn()
    with observe.scope("af.outside"):
        pass


def test_scope_is_shared_no_op_until_a_profiler_records():
    assert observe.scope("af.a") is observe.scope("af.b")
    with torch.profiler.profile(activities=CPU):
        span = observe.scope("af.a")
    assert isinstance(span, torch.profiler.record_function)
    assert not hasattr(observe, "annotate")


def _write_trace(logdir, events):
    run = logdir / "plugins" / "profile" / "run"
    run.mkdir(parents=True)
    with gzip.open(run / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)


def test_summarize_trace_keeps_host_and_device_apart(tmp_path):
    def x(name, cat, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": 0, "dur": dur}

    _write_trace(tmp_path, [
        x("af.HPSS.hpss", "user_annotation", 90.0),
        x("aten::mul", "cpu_op", 30.0),
        x("cudaLaunchKernel", "cuda_runtime", 5.0),
        x("fft_reg_kernel", "kernel", 40.0),
        x("fft_reg_kernel", "kernel", 20.0),
        x("Memcpy HtoD", "gpu_memcpy", 7.0),
        x("foo.py(1): f", "python_function", 100.0)])
    rows = observe.summarize_trace(str(tmp_path))
    assert rows == [("fft_reg_kernel", 60.0, 2), ("Memcpy HtoD", 7.0, 1)]
    both = {n for n, _, _ in observe.summarize_trace(str(tmp_path),
                                                     include_host=True)}
    assert both == {"af.HPSS.hpss", "aten::mul", "cudaLaunchKernel",
                    "fft_reg_kernel", "Memcpy HtoD", "foo.py(1): f"}
