"""The plain references held to ``audioflux_torch`` on the CPU at small
sizes.  The references build their own constants; these tests show they
are the program's."""

import numpy as np
import pytest
import torch

from benchmark.harness import load_json, module
from benchmark.reference import common
from benchmark.tests.conftest import ROOT

import audioflux_torch as af
from audioflux_torch.mir.onset import peak_pick
from audioflux_torch.ops.cuda_median import median_filter_last_axis
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.transforms.spectrogram import dct_matrix

CFG = ROOT / "benchmark" / "configs"


def cfg(name):
    return load_json(CFG / f"{name}.json")


def test_mel_bank_is_the_programs():
    plan = af.MelSpectrogram(num=128, samplate=32000, radix2_exp=11,
                             slide_length=512, device="cpu")
    np.testing.assert_array_equal(common.mel_filter_bank(128, 2048, 32000),
                                  plan.filter_bank)


@pytest.mark.parametrize("kind, wt", [("hann", af.WindowType.HANN),
                                      ("hamm", af.WindowType.HAMM)])
def test_windows_are_the_programs(kind, wt):
    np.testing.assert_allclose(common.fft_window(kind, 2048),
                               get_fft_window(wt, 2048), rtol=0, atol=1e-7)


def test_dct_is_the_programs():
    np.testing.assert_allclose(common.dct_matrix(128), dct_matrix(128),
                               rtol=0, atol=1e-7)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12)])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10, -1.0])
    assert torch.equal(common.round_tf32(x), want)


def test_mel_mfcc_reference_matches_the_program():
    c = cfg("mel_mfcc_32k")
    ref = module("reference", "mel_mfcc_32k")
    x = torch.randn(3, 2048 + 512 * 9, generator=torch.Generator().manual_seed(5)) * 0.2
    plan = af.MelSpectrogram(num=128, samplate=32000, radix2_exp=11,
                             slide_length=512, device="cpu")
    mel, cc = plan.spectrogram_mfcc_fused(x, cc_num=13)
    r = ref.Reference(c, "cpu").run(x)
    readings = ref.compare({"mel": mel, "mfcc": cc}, r)
    assert max(readings.values()) < 1e-5, readings


def test_mir_reference_matches_the_program():
    from benchmark import traffic
    c = cfg("mir_pipeline_32k")
    ref = module("reference", "mir_pipeline_32k")
    entry = module("entries", "mir_pipeline").Entry(c, "cpu")
    x = traffic.mir((2, 96000), traffic.generator(9, "cpu"), "cpu", 32000)

    class Spans:
        def span(self, name):
            return torch.autograd.profiler.record_function(name)
    got = entry.call(x, Spans())
    r = ref.Reference(c, "cpu").run(x)
    readings = ref.compare(got, r)
    assert readings["onset_share"] == 0, readings
    assert max(readings.values()) < 1e-5, readings
    assert sum(len(p) for p in r["points"]) > 4


def test_peak_pick_reference_matches_the_program():
    ref = module("reference", "mir_pipeline_32k").Reference(
        cfg("mir_pipeline_32k"), "cpu")
    rng = np.random.default_rng(3)
    for _ in range(20):
        env = rng.random(400).astype(np.float32) ** 3
        env[rng.integers(400)] = 0.0
        env[rng.integers(400)] = 1.0
        want = peak_pick(env, ref.pre_max, ref.post_max, ref.pre_avg,
                         ref.post_avg, ref.wait, ref.delta)
        np.testing.assert_array_equal(ref.onset_points(env), want)


@pytest.mark.parametrize("order, dim", [(21, 0), (31, 1)])
def test_median_reference_matches_the_program(order, dim):
    ref = module("reference", "mir_pipeline_32k").Reference(
        cfg("mir_pipeline_32k"), "cpu")
    mag = torch.rand(300, 129, generator=torch.Generator().manual_seed(order))
    want = median_filter_last_axis(mag.contiguous(), order,
                                   dim=-2 if dim == 0 else -1)
    assert torch.equal(ref._median(mag, order, dim), want)
