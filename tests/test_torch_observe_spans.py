"""The port's spans (``audioflux_torch.observe.scope``): while a profiler
records, each entry call the benchmark's cells make and each kernel
wrapper is one ``user_annotation`` event in the exported trace, the
wrappers' nested by time inside the entries'; while none records, no
``record_function`` is entered at all.  On the CPU the wrappers take their
plain versions, under the same spans.

The set-up spans (``observe.setup``): each site records once a key, with
its parent; a steady call of each cell's entry records none.  Run the
card's cases with ``python3 -m pytest --noconftest -m card
tests/test_torch_observe_spans.py``."""

import contextlib
import functools
import gzip
import json
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

from audioflux_torch import observe
from audioflux_torch.mir.pitch import PitchPEF
from audioflux_torch.mir.pitch_yin import PitchYIN
from audioflux_torch.ops import _build
from audioflux_torch.ops import (cuda_cqt, cuda_cwt, cuda_fft, cuda_hpss,
                                 cuda_median, cuda_pef, cuda_scatter,
                                 cuda_unwrap, cuda_yin, fused_mel)
from audioflux_torch.transforms.cqt import CQT
from audioflux_torch.transforms.spectrogram import MelSpectrogram
from audioflux_torch.ops import fft as afft
from benchmark import harness, traffic

CPU = [torch.profiler.ProfilerActivity.CPU]

# the benchmark's cells at a test's size: (clips, samples) a call
CELLS = {"mel_mfcc.corpus": (3, 2048 + 512 * 7), "mir.corpus": (2, 64000),
         "wavelet.corpus": (1, 1 << 13), "pitch.corpus": (2, 8192),
         "cqt.corpus": (2, 16000)}
# plan arguments cut with the request where the plan fixes its length:
# 2^13 samples, padded to 2^14, still take the CWT kernel's wrapper
PLANS = {"wavelet.corpus": {"radix2_exp": 13}}

# the entry spans a call of each cell opens, and how often
ENTRY_SPANS = {
    "mel_mfcc.corpus": {"af.MelSpectrogram.spectrogram_mfcc_fused": 1},
    "mir.corpus": {"af.PitchYIN.pitch": 1,
                   "af.MelSpectrogram.spectrogram": 1,
                   "af.Spectral.flux": 1,
                   "af.peak_pick": CELLS["mir.corpus"][0],
                   "af.HPSS.hpss": 1},
    "wavelet.corpus": {"af.CWT.cwt": 1, "af.Synsq.synsq": 1},
    "pitch.corpus": {"af.PitchNCF.pitch": 1, "af.PitchHPS.pitch": 1,
                     "af.PitchPEF.pitch": 1,
                     "af.HarmonicRatio.harmonic_ratio": 1},
    # the octave chain's six 2:1 resamples nest inside the CQT's span
    "cqt.corpus": {"af.CQT.cqt": 1, "af.CQT.chroma": 1,
                   "af.Resample.resample": 6},
}
# cells whose call runs no hand-written kernel, so opens no kernel span
NO_KERNEL = {"cqt.corpus"}
# the calls a cell's call makes to torch.fft through ops.fft.rfft (the
# CQT's 512-point transform, one an octave)
RFFT_LIBRARY_CALLS = {"cqt.corpus": 7}


class _NoCallerSpans:
    def span(self, name):
        return contextlib.nullcontext()


def _cell_call(cell, device="cpu"):
    bench = harness.load_benchmark()
    parts = harness.cell_parts(bench, cell)
    wl = dict(parts["workload"], pool=1)
    wl["batch"], wl["samples"] = CELLS[cell]
    x = traffic.make_pool(wl, 2**31 + 5, device)[0]
    for plan in parts["config"]["plans"].values():
        plan.update(PLANS.get(cell, {}))
    entry = harness.build_entry(parts["config"], device)
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


# built once, so that a wrapper's call opens no plan's set-up span
_CQT = CQT(num=24, samplate=32000, low_fre=1000.0, device="cpu")


def _cqt_octaves():
    plan = _CQT
    levels = [_real(2, 8000 >> (plan.octave_num - 1 - o), seed=o)
              for o in range(plan.octave_num)]
    return cuda_cqt.cqt_octaves(levels, plan._octave_slides(), plan._kernels_t,
                                plan._scale_t, fft_length=plan.fft_length,
                                T=8000 // plan.slide_length + 1)


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
    "yin_pitch": lambda: cuda_yin.yin_pitch(
        _real(1, 4096), fft_length=2048, slide_length=512, auto_length=1024,
        min_index=16, max_index=1023, samplate=32000.0, thresh=0.1),
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
    # on the CPU its plain version calls rfft's library route, no wrapper
    "cqt_octaves": _cqt_octaves,
}

_HPSS_PLAN = dict(fft_length=2048, slide_length=512)

# the HPSS kernels' wrappers: on the CPU their plain versions call the FFT
# wrappers, whose spans nest inside theirs
HPSS_KERNELS = {
    "hpss_magnitude": lambda: cuda_hpss.hpss_magnitude(
        _real(2, 4096), torch.hann_window(2048), **_HPSS_PLAN),
    "hpss_resynth": lambda: cuda_hpss.hpss_resynth(
        _real(2, 4096), torch.hann_window(2048),
        _real(2, 5, 1025).abs(), _real(2, 5, 1025, seed=1).abs(),
        **_HPSS_PLAN),
}

_PEF = PitchPEF(device="cpu")

# PEF's kernels' wrappers: on the CPU their plain versions call the FFT
# wrappers too
PEF_KERNELS = {
    "pef_log_power": lambda: cuda_pef.pef_log_power(
        _real(1, 6144), _PEF._window_t, _PEF._pos_t, _PEF._w_t,
        _PEF._band_width_t, fft_length=4096, slide_length=1024,
        bins=_PEF._pos_bins),
    "pef_xcorr_pitch": lambda: cuda_pef.pef_xcorr_pitch(
        _real(2, 8192).abs(), _PEF._ff_half, _PEF._log_fre_t,
        **_PEF._xcorr_plan()),
}

CALLS = ({f"cell:{c}": c for c in CELLS}
         | {f"kernel:{k}": k for k in KERNELS}
         | {f"kernel:{k}": k for k in HPSS_KERNELS}
         | {f"kernel:{k}": k for k in PEF_KERNELS})


def _make(case):
    kind, name = case.split(":")
    if kind == "cell":
        return _cell_call(name)
    return KERNELS.get(name) or HPSS_KERNELS.get(name) or PEF_KERNELS[name]


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
    # the set-up spans a first call may open (a library's load) are apart
    entries = {n: c for n, c in counts.items()
               if not n.startswith(("af.kernel.", "af.setup."))}
    assert entries == ENTRY_SPANS[cell]
    kernels = [s for s in spans if s[0].startswith("af.kernel.")]
    assert bool(kernels) == (cell not in NO_KERNEL)
    outer = [s for s in spans if s[0] in ENTRY_SPANS[cell]]
    for _, s, e in kernels:      # nested by time under an entry's span
        assert any(a <= s and e <= b for _, a, b in outer)
    if cell == "mir.corpus":     # HPSS's two medians
        assert counts["af.kernel.median_filter_last_axis"] == 2
    if cell == "wavelet.corpus":  # the CWT's kernel in its span, the
        # squeeze's two in theirs
        spans_of = {n: (a, b) for n, a, b in spans}
        for entry, kernel in (("af.CWT.cwt", "cwt_ifft_bank"),
                              ("af.Synsq.synsq", "synsq_bins"),
                              ("af.Synsq.synsq", "columnar_scatter")):
            assert counts[f"af.kernel.{kernel}"] == 1
            (a, b), (s, e) = spans_of[entry], spans_of[f"af.kernel.{kernel}"]
            assert a <= s and e <= b
    if cell == "cqt.corpus":     # the resamples inside the CQT's span
        (_, a, b), = [sp for sp in spans if sp[0] == "af.CQT.cqt"]
        (_, c, d), = [sp for sp in spans if sp[0] == "af.CQT.chroma"]
        assert b <= c
        for name, s, e in spans:
            if name == "af.Resample.resample":
                assert a <= s and e <= b


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rfft_library_calls_a_call(cell):
    call = _cell_call(cell)
    before = afft.rfft.library_calls
    call()
    assert afft.rfft.library_calls - before == RFFT_LIBRARY_CALLS.get(cell, 0)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_each_kernel_wrapper_records_its_span_once(name, tmp_path):
    spans = _recorded(KERNELS[name], tmp_path)
    assert [n for n, _, _ in spans] == [f"af.kernel.{name}"]


def _hold_nested(name, fn, tmp_path):
    """One span of the wrapper, the FFT wrappers' inside it."""
    spans = _recorded(fn, tmp_path)
    own = [sp for sp in spans if sp[0] == f"af.kernel.{name}"]
    assert len(own) == 1
    _, a, b = own[0]
    inner = [sp for sp in spans if sp is not own[0]]
    assert inner and all(n.startswith("af.kernel.fft_") for n, _, _ in inner)
    assert all(a <= s and e <= b for _, s, e in inner)


@pytest.mark.parametrize("name", sorted(HPSS_KERNELS))
def test_hpss_kernel_wrappers_record_their_spans(name, tmp_path):
    _hold_nested(name, HPSS_KERNELS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(PEF_KERNELS))
def test_pef_kernel_wrappers_record_their_spans(name, tmp_path):
    _hold_nested(name, PEF_KERNELS[name], tmp_path)


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


# -- set-up spans ------------------------------------------------------------

# the plans each cell's entry builds, by the set-up span of each; Spectral
# is built inside calls too (``Onset.onset`` with ``index_arr``), so its
# constructor opens none
PLAN_SPANS = {
    "mel_mfcc.corpus": {"af.setup.plan.MelSpectrogram"},
    "mir.corpus": {"af.setup.plan.PitchYIN", "af.setup.plan.MelSpectrogram",
                   "af.setup.plan.Onset", "af.setup.plan.HPSS"},
    "wavelet.corpus": {"af.setup.plan.CWT", "af.setup.plan.Synsq"},
    "pitch.corpus": {"af.setup.plan.PitchNCF", "af.setup.plan.PitchHPS",
                     "af.setup.plan.PitchPEF",
                     "af.setup.plan.HarmonicRatio"},
    "cqt.corpus": {"af.setup.plan.CQT"},
}


@pytest.fixture
def record(monkeypatch):
    """An empty set-up record for the test; returns its reader."""
    monkeypatch.setattr(observe, "_SETUP", [])
    return observe.setup_spans


def _check_nesting(spans):
    """Each span ends after it starts and lies inside a span of its
    parent's name."""
    for name, parent, s, e in spans:
        assert s <= e
        if parent is not None:
            assert any(n == parent and a <= s and e <= b
                       for n, _, a, b in spans)


def _tables(monkeypatch, tmp_path):
    """The FFT's kernel table, which holds the twiddle table, three times,
    through caches of the test's own."""
    for name in ("twiddle_table", "_kernel_table"):
        fresh = functools.lru_cache(maxsize=None)(
            getattr(cuda_fft, name).__wrapped__)
        monkeypatch.setattr(cuda_fft, name, fresh)
    for _ in range(3):
        cuda_fft._kernel_table(256, torch.device("cpu"))
    return [("af.setup.table.cuda_fft.twiddle_table",
             "af.setup.table.cuda_fft._kernel_table"),
            ("af.setup.table.cuda_fft._kernel_table", None)]


def _load_and_build(monkeypatch, tmp_path):
    """The peak pick's host library, loaded three times into an empty
    build folder: hashed, built and opened once."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the host library cannot be built here")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    libs = [_build.load("libafpp") for _ in range(3)]
    assert all(lib is libs[0] for lib in libs)
    return [("af.setup.build.libafpp", "af.setup.load.libafpp"),
            ("af.setup.load.libafpp", None)]


def _launches(monkeypatch, tmp_path):
    """Two C entries (stand-ins) launched again and again on two cards
    (stand-ins), the first launch inside a set-up span of the caller's."""
    monkeypatch.setattr(_build, "require_sm90", lambda device: None)
    monkeypatch.setattr(_build, "_LAUNCHED", set())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    with observe.setup("af.setup.plan.Caller"):
        _build.launch(fn, "a", torch.device("cuda", 0))
    for i in range(20):
        _build.launch(fn, "a", torch.device("cuda", i % 2))
        _build.launch(fn, "b", torch.device("cuda", 0))
    assert len(calls) == 41
    return [("af.setup.launch.a", "af.setup.plan.Caller"),
            ("af.setup.plan.Caller", None),
            ("af.setup.launch.b", None), ("af.setup.launch.a", None)]


def _plans(monkeypatch, tmp_path):
    """A plan built twice, and one built through its base's constructor,
    named by its own class."""
    PitchYIN(device="cpu")
    PitchYIN(device="cpu")
    MelSpectrogram(num=16, radix2_exp=9, slide_length=128, device="cpu")
    return [("af.setup.plan.PitchYIN", None)] * 2 + [
        ("af.setup.plan.MelSpectrogram", None)]


SITES = {"table": _tables, "load and build": _load_and_build,
         "launch": _launches, "plan": _plans}


@pytest.mark.parametrize("site", sorted(SITES))
def test_each_setup_site_records_once_a_key_with_its_parent(
        site, record, monkeypatch, tmp_path):
    want = SITES[site](monkeypatch, tmp_path)
    spans = record()
    assert [(n, p) for n, p, _, _ in spans] == want
    _check_nesting(spans)


def _outer_and_inner():
    with observe.setup("af.setup.outer"):
        with observe.setup("af.setup.inner"):
            pass


def test_setup_is_a_record_function_while_a_profiler_records(record,
                                                             tmp_path):
    spans = _recorded(_outer_and_inner, tmp_path)
    (_, a, b), = [sp for sp in spans if sp[0] == "af.setup.outer"]
    (_, c, d), = [sp for sp in spans if sp[0] == "af.setup.inner"]
    assert a <= c and d <= b
    assert [(n, p) for n, p, _, _ in record()] == [
        ("af.setup.inner", "af.setup.outer"), ("af.setup.outer", None)]


def test_setup_enters_no_record_function_without_a_profiler(record,
                                                            monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _outer_and_inner()
    assert [n for n, _, _, _ in record()] == ["af.setup.inner",
                                              "af.setup.outer"]


def test_the_package_import_is_a_setup_span():
    imports = [sp for sp in observe.setup_spans()
               if sp[0] == "af.setup.import"]
    assert len(imports) == 1
    _, parent, s, e = imports[0]
    assert parent is None and s < e


def test_setup_spans_is_a_copy(record):
    _outer_and_inner()
    got = record()
    got.clear()
    assert len(record()) == 2


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_steady_call_adds_no_setup_span(cell):
    before = len(observe.setup_spans())
    call = _cell_call(cell)
    built = {n for n, _, _, _ in observe.setup_spans()[before:]}
    assert built >= PLAN_SPANS[cell]
    assert "af.setup.plan.Spectral" not in built
    call()                       # the first call may build tables, load
    n = len(observe.setup_spans())
    call()
    assert len(observe.setup_spans()) == n
    _check_nesting(observe.setup_spans()[before:])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_first_launch_is_a_setup_span_once_an_entry_and_card(
        card, cell, record, monkeypatch):
    monkeypatch.setattr(_build, "_LAUNCHED", set())
    call = _cell_call(cell, card)
    call()
    torch.cuda.synchronize(card)
    launches = Counter(n for n, _, _, _ in record()
                       if n.startswith("af.setup.launch."))
    assert launches and set(launches.values()) == {1}
    n = len(record())
    call()
    torch.cuda.synchronize(card)
    assert len(record()) == n
    _check_nesting(record())
