"""The CQT tier against the benchmark's plain float64 reference of
``cqt_chroma_32k`` (``benchmark/reference/cqt_chroma_32k.py``), on the
CPU at a small size: the reference's band frequencies, kernel bank,
resampler taps, scale and chroma bank are the program's; the CQT and its
chroma stay within the configuration's limits on the seeded ``mir``
signal; the check reads "not correct" for half of each clip's frames
left out, one value of each output moved by a hundredth of its peak, and
the TF32 control.  Also: the reference imports neither JAX nor the
program, and the work counts at the cell's size."""

import contextlib
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from audioflux_torch.transforms.cqt import CQT, chroma_cqt_filter_bank
from audioflux_torch.utils.convert import note_to_hz
from benchmark import peaks, traffic
from benchmark.harness import ROOT, load_json, module

ref = module("reference", "cqt_chroma_32k")
counts = module("counts", "cqt_chroma_32k")
CFG = load_json(ROOT / "benchmark" / "configs" / "cqt_chroma_32k.json")
CARD = "NVIDIA H100 80GB HBM3"
ROWS, SAMPLES = 2, 48000          # 2 clips of 1.5 s: 376 frames each
KEYS = ("cqt", "chroma")


class _NoSpans:
    def span(self, name):
        return contextlib.nullcontext()


def _entry():
    return module("entries", "cqt_chroma").Entry(CFG, "cpu")


@pytest.fixture(scope="module")
def outputs():
    """(program, float64 reference, audio) on the seeded signal."""
    x = traffic.mir((ROWS, SAMPLES), traffic.generator(2**31 + 67, "cpu"),
                    "cpu", 32000)
    got = _entry().call(x, _NoSpans())
    return got, ref.Reference(CFG, "cpu").run(x), x


def test_plan_is_the_programs():
    c, r = _entry().cqt, ref.Reference(CFG, "cpu").plan
    assert (r.fft_length, r.slide, r.octaves) == (512, 128, 7)
    assert (c.fft_length, c.slide_length, c.octave_num) == (
        r.fft_length, r.slide, r.octaves)
    assert ref.c1() == pytest.approx(note_to_hz("C1"), rel=1e-12)
    np.testing.assert_array_equal(r.fre, c.fre_band_arr)
    # the kernel bank: (12, 257), its 131 nonzeros where the program's are
    assert r.kernel.shape == (12, 257)
    assert np.count_nonzero(r.kernel) == 131
    np.testing.assert_array_equal(r.kernel, c._kernels[-1])
    # the scale: float64 here, float32 quotients in the program
    np.testing.assert_allclose(r.scale, c._scale, rtol=2e-7)
    np.testing.assert_array_equal(
        r.chroma, chroma_cqt_filter_bank(12, 84, 12, c.low_fre))


def test_resampler_taps_are_the_programs():
    r = ref.Reference(CFG, "cpu").plan
    mat = _entry().cqt._resampler._plan().mat.numpy()
    assert mat.shape == (66, 1)
    # the window matrix's column: the left taps reversed, then the right
    col = mat[:, 0]
    nz = np.flatnonzero(col)
    assert (len(r.left), len(r.right), len(nz)) == (32, 31, 63)
    np.testing.assert_array_equal(col[nz[0]:nz[-1] + 1],
                                  np.concatenate([r.left[::-1], r.right]))


@pytest.mark.parametrize("bpo, low", [(12, None), (24, None), (36, 55.0)])
def test_bands_and_kernels_at_other_resolutions(bpo, low):
    c = CQT(num=3 * bpo, bin_per_octave=bpo, low_fre=low, device="cpu")
    p = ref.Plan(dict(CFG["plans"]["cqt"], num=3 * bpo, bin_per_octave=bpo,
                      low_fre=low), CFG["plans"]["chroma"])
    np.testing.assert_array_equal(p.fre, c.fre_band_arr)
    assert p.fft_length == c.fft_length
    np.testing.assert_array_equal(p.kernel, c._kernels[-1])


@pytest.mark.parametrize("chroma_num, bpo, low", [
    (12, 12, 32.703196), (12, 24, 32.703196), (12, 36, 55.0),
    (12, 12, 55.0), (6, 12, 32.703196), (4, 12, 49.0)])
def test_chroma_bank_is_the_programs(chroma_num, bpo, low):
    np.testing.assert_array_equal(
        ref.chroma_bank(chroma_num, 7 * bpo, bpo, low),
        chroma_cqt_filter_bank(chroma_num, 7 * bpo, bpo, low))


def test_program_is_within_the_limits(outputs):
    got, want, _ = outputs
    t = SAMPLES // 128 + 1
    assert tuple(got["cqt"].shape) == (ROWS, 84, t, 2)
    assert tuple(got["chroma"].shape) == (ROWS, 12, t)
    assert all(got[k].dtype == torch.float32 for k in KEYS)
    assert all(tuple(want[k].shape) == tuple(got[k].shape) for k in KEYS)
    readings = ref.compare(got, want)
    limits = CFG["limits"]
    assert set(readings) == set(limits)
    assert all(readings[k] <= limits[k] for k in limits), readings
    # every frame has energy, so the chroma's largest bin is 1
    assert torch.allclose(want["chroma"].amax(dim=1),
                          torch.ones((), dtype=torch.float64))


def _moved(fault: str, got: dict) -> dict:
    """``half``: the second half of each clip's frames zero; ``<key>``: one
    value of that output moved by a hundredth of its peak."""
    res = {k: v.clone() for k, v in got.items()}
    if fault == "half":
        for k, v in res.items():
            t = v.shape[2]
            v[:, :, t // 2:] = 0
        return res
    v = res[fault]
    flat = v.reshape(-1)
    flat[flat.numel() // 3] += 0.01 * float(v.abs().max())
    return res


@pytest.mark.parametrize("fault", ["half", *KEYS, "tf32"])
def test_fault_is_not_correct(outputs, fault):
    got, want, x = outputs
    if fault == "tf32":
        bad = ref.Reference(CFG, "cpu").run(x, "tf32")
    else:
        bad = _moved(fault, got)
    readings = ref.compare(bad, want)
    limits = CFG["limits"]
    assert any(readings[k] > limits[k] for k in limits), readings
    if fault in KEYS:    # the moved output alone fails
        failed = {k for k in limits if readings[k] > limits[k]}
        assert failed == {f"{fault}_gap"}, readings


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.cqt_chroma_32k, "
            "benchmark.counts.cqt_chroma_32k; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'audioflux_tpu', 'audioflux_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# the cell's size: 128 clips of 30 s, 7,501 frames in each octave
CELL_ROWS, CELL_N, CELL_T = 128, 960_000, 7501


def test_counts_at_the_cells_size():
    n_bytes, ops = counts.cqt_need(CFG, CELL_ROWS, CELL_N)
    levels = CELL_N // 2 + CELL_N // 4 + CELL_N // 8 + CELL_N // 16 + (
        CELL_N // 32 + CELL_N // 64)
    assert levels == 945_000
    assert n_bytes == 4 * CELL_ROWS * (CELL_N + 2 * levels
                                       + 2 * 84 * CELL_T)
    frames = 7 * CELL_ROWS * CELL_T
    assert ops == frames * (2.5 * 512 * 9 + 8 * 131) + (
        2 * 63 * CELL_ROWS * levels)
    peak = peaks.PEAKS[CARD]
    assert ops / peak["fp32_flop_per_s"] > n_bytes / peak["hbm_bytes_per_s"]
    assert n_bytes / 1e9 == pytest.approx(2.104, abs=5e-4)
    assert 1e3 * peaks.bound_s(CARD, n_bytes, ops) == pytest.approx(
        1.488, abs=5e-4)
    assert ops <= 7 * CELL_ROWS * CELL_T * (2.5 * 512 * math.log2(512)
                                            + 8 * 12 * 257) + (
        2 * 66 * CELL_ROWS * levels)
