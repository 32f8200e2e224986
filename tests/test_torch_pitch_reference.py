"""The pitch tier against the benchmark's plain float64 reference of
``pitch_track_32k`` (``benchmark/reference/pitch_track_32k.py``), on the
CPU at a small size: the reference's grids and filter are the program's,
the four estimators stay within the configuration's limits on the seeded
``mir`` signal, and the check reads "not correct" for half a batch's
frames left out, a pitch moved two steps of its grid on 1% of the frames,
a harmonic ratio moved by 1e-3 and the bfloat16 control.  Also: the
reference imports neither JAX nor the program, the work counts at the
cell's size, and the four entry spans in a profiler trace."""

import contextlib
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from audioflux_torch.mir.harmonic_ratio import HarmonicRatio
from audioflux_torch.mir.pitch import PitchHPS, PitchNCF, PitchPEF
from benchmark import peaks, traffic
from benchmark.harness import ROOT, load_json, module

ref = module("reference", "pitch_track_32k")
counts = module("counts", "pitch_track_32k")
CFG = load_json(ROOT / "benchmark" / "configs" / "pitch_track_32k.json")
CARD = "NVIDIA H100 80GB HBM3"
ROWS, SAMPLES = 2, 64000          # 2 recordings of 2 s: 59 frames each
KEYS = ("ncf", "hps", "pef", "hr")


class _NoSpans:
    def span(self, name):
        return contextlib.nullcontext()


def _entry():
    return module("entries", "pitch_track").Entry(CFG, "cpu")


@pytest.fixture(scope="module")
def outputs():
    """(program, float64 reference) on the seeded signal."""
    x = traffic.mir((ROWS, SAMPLES), traffic.generator(2**31 + 61, "cpu"),
                    "cpu", 32000)
    got = _entry().call(x, _NoSpans())
    return got, ref.Reference(CFG, "cpu").run(x), x


def test_grids_and_filter_are_the_programs():
    e = _entry()
    r = ref.Reference(CFG, "cpu")
    assert (e.ncf.min_index, e.ncf.max_index) == r.ncf_lags
    big, lo, hi, harmonics = r.hps_grid
    assert (e.hps.interp_fft_length, e.hps.min_index, e.hps.max_index,
            e.hps.harmonic_count) == (big, lo, hi, harmonics)
    g = r.pef_grid
    assert (e.pef.min_index, e.pef.max_index, e.pef._pad_num,
            e.pef.xcorr_fft_length) == (g.min_index, g.max_index, g.pad_num,
                                        g.xcorr_n)
    np.testing.assert_allclose(g.log_fre, e.pef._log_fre, rtol=1e-6)
    np.testing.assert_allclose(g.filter, e.pef._filter, rtol=0, atol=1e-6)
    # the program's band widths are differences of its float32 grid, with
    # up to 5e-4 of rounding where the points lie closest
    np.testing.assert_allclose(g.band_width, e.pef._band_width, rtol=1e-3)
    # where each log-grid point falls on the linear grid, in bins (the
    # program's grid is float32: a few parts in 1e7 off)
    np.testing.assert_allclose(g.pos + g.weight,
                               e.pef._pos_t.numpy() + e.pef._w_t.numpy(),
                               rtol=1e-6)
    assert r.hr_m == e.hr.max_length
    for key, plan in (("ncf", e.ncf), ("hps", e.hps), ("pef", e.pef),
                      ("hr", e.hr)):
        np.testing.assert_array_equal(r.windows[key].numpy(), plan.window)


def test_program_is_within_the_limits(outputs):
    got, want, _ = outputs
    t = (SAMPLES - 4096) // 1024 + 1
    assert all(tuple(got[k].shape) == (ROWS, t) for k in KEYS)
    assert all(got[k].dtype == torch.float32 for k in KEYS)
    readings = ref.compare(got, want)
    limits = CFG["limits"]
    assert set(readings) == set(limits)
    assert all(readings[k] <= limits[k] for k in limits), readings
    for k in ("ncf", "hps", "pef"):
        assert bool(((want[k] >= 32) & (want[k] <= 2001)).all()), k


def _moved(fault: str, got: dict) -> dict:
    """``half``: the second half of each recording's frames zero; ``<key>``:
    that output moved on every hundredth frame (two steps of the
    estimator's grid, or 1e-3 of a harmonic ratio)."""
    res = {k: v.clone() for k, v in got.items()}
    if fault == "half":
        for v in res.values():
            v[:, v.shape[1] // 2:] = 0
        return res
    steps = ref.grid_steps()
    v = res[fault].reshape(-1)
    sel = slice(0, None, 100)
    if fault == "ncf":
        v[sel] = steps["sr"] / (steps["sr"] / v[sel] + 2)
    elif fault == "hps":
        v[sel] += 2 * steps["hps_hz"]
    elif fault == "pef":
        v[sel] *= math.exp(2 * steps["pef_log"])
    else:
        v[sel] += 1e-3
    return res


@pytest.mark.parametrize("fault", ["half", *KEYS, "bf16"])
def test_fault_is_not_correct(outputs, fault):
    got, want, x = outputs
    if fault == "bf16":
        bad = ref.Reference(CFG, "cpu").run(x, "bf16")
    else:
        bad = _moved(fault, got)
    readings = ref.compare(bad, want)
    limits = CFG["limits"]
    assert any(readings[k] > limits[k] for k in limits), readings
    if fault in KEYS:    # the moved output alone fails
        failed = {k for k in limits if readings[k] > limits[k]}
        assert failed == {f"{fault}_flips"}, readings


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.pitch_track_32k, "
            "benchmark.counts.pitch_track_32k; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'audioflux_tpu', 'audioflux_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# the cell's size: 8 recordings of 300 s, 9,372 frames each (74,976)
CELL_ROWS, CELL_N, CELL_T = 8, 9_600_000, 9372


@pytest.mark.parametrize("stage, transforms, bound_ms", [
    # forward at 8192 of 4,096 samples; inverse to 1,001 lags (L 1024)
    ("ncf", [(8192, 4096), (8192, 1024)], 0.50),
    # forward at 8192 of 4,096 samples; inverse to 979 lags (L 1024)
    ("hr", [(8192, 4096), (8192, 1024)], 0.50),
    # forward at 32768 of 4,096 samples (10,001 bins read)
    ("hps", [(32768, 4096)], 1.10),
    # forward at 8192 (L 4096); forward at 32768 of the 8,192 log-grid
    # points (L 8192); inverse at 32768 to 7,244 lags (L 8192)
    ("pef", [(8192, 4096), (32768, 8192), (32768, 8192)], 2.66),
])
def test_counts_at_the_cells_size(stage, transforms, bound_ms):
    n_bytes, ops = getattr(counts, f"{stage}_need")(CFG, CELL_ROWS, CELL_N)
    assert n_bytes == 4 * CELL_ROWS * (CELL_N + CELL_T)
    frames = CELL_ROWS * CELL_T
    assert ops == frames * sum(2.5 * n * math.log2(lg)
                               for n, lg in transforms)
    # no more than the full real transforms' 2.5 N log2 N a frame
    assert ops <= frames * sum(2.5 * n * math.log2(n) for n, _ in transforms)
    peak = peaks.PEAKS[CARD]
    assert ops / peak["fp32_flop_per_s"] > n_bytes / peak["hbm_bytes_per_s"]
    assert 1e3 * peaks.bound_s(CARD, n_bytes, ops) == pytest.approx(
        bound_ms, abs=0.005)


ENGINES = {
    "af.PitchNCF.pitch": (lambda: PitchNCF(device="cpu"), "pitch",
                          "fft_autocorr_frames"),
    "af.PitchHPS.pitch": (lambda: PitchHPS(device="cpu"), "pitch", "fft_fwd"),
    "af.PitchPEF.pitch": (lambda: PitchPEF(device="cpu"), "pitch", "fft_inv"),
    "af.HarmonicRatio.harmonic_ratio": (lambda: HarmonicRatio(device="cpu"),
                                        "harmonic_ratio",
                                        "fft_autocorr_frames"),
}


@pytest.mark.parametrize("span", sorted(ENGINES))
def test_entry_span_wraps_the_engines_kernels(span, tmp_path):
    make, method, kernel = ENGINES[span]
    plan = make()
    x = torch.randn(1, 8192, generator=torch.Generator().manual_seed(7))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        getattr(plan, method)(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in
             json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("af.")]
    entries = [s for s in spans if not s[0].startswith("af.kernel.")]
    assert [n for n, _, _ in entries] == [span]
    _, a, b = entries[0]
    inner = [s for s in spans if s[0].startswith("af.kernel.")]
    assert f"af.kernel.{kernel}" in {n for n, _, _ in inner}
    assert all(a <= s and e <= b for _, s, e in inner)
