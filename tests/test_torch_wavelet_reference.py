"""The wavelet tier against the benchmark's plain float64 reference of
``cwt_synsq_32k`` (``benchmark/reference/cwt_synsq_32k.py``), on the CPU
at a small size: the reference's morlet bank and band frequencies are the
program's, ``CWT.cwt`` -> ``Synsq.synsq`` stays within the configuration's
limits, and the check reads "not correct" for a half-missing batch, a
moved value and the bfloat16 control."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from audioflux_torch import (CWT, SpectralFilterBankScaleType, Synsq,
                             WaveletContinueType)
from audioflux_torch.transforms.cwt import cwt_filter_bank
from benchmark import harness, traffic
from benchmark.harness import ROOT, load_json, module

CELL = "wavelet.corpus"
ref = module("reference", "cwt_synsq_32k")


def cfg(radix2_exp=14):
    c = load_json(ROOT / "benchmark" / "configs" / "cwt_synsq_32k.json")
    for plan in c["plans"].values():
        plan["radix2_exp"] = radix2_exp
    return c


@pytest.mark.parametrize("radix2_exp", [14, 15])
def test_bank_and_band_frequencies_are_the_programs(radix2_exp):
    c = cfg(radix2_exp)
    r = ref.Reference(c, "cpu")
    p = c["plans"]["cwt"]
    plan = CWT(num=p["num"], radix2_exp=radix2_exp, samplate=p["samplate"],
               wavelet_type=WaveletContinueType.MORLET, device="cpu")
    bank, fre, _ = cwt_filter_bank(
        p["num"], plan.data_length, p["samplate"], plan.pad_length,
        WaveletContinueType.MORLET, p["gamma"], p["beta"],
        SpectralFilterBankScaleType.OCTAVE, plan.low_fre, plan.high_fre,
        p["bin_per_octave"])
    assert r.pad == plan.pad_length
    np.testing.assert_array_equal(r.fre, fre)
    # the program keeps its rows high-frequency first; the reference's
    # ascend, as both outputs do
    np.testing.assert_array_equal(r.bank.numpy(), bank[::-1])


def test_program_is_within_the_limits():
    c = cfg(14)
    p, s = c["plans"]["cwt"], c["plans"]["synsq"]
    x = traffic.mir((4, 1 << 14), traffic.generator(2**31 + 41, "cpu"), "cpu",
                    p["samplate"])
    octave = SpectralFilterBankScaleType.OCTAVE
    plan = CWT(num=p["num"], radix2_exp=14, samplate=p["samplate"],
               wavelet_type=WaveletContinueType.MORLET, scale_type=octave,
               device="cpu")
    w = plan.cwt(x)
    sq = Synsq(num=s["num"], radix2_exp=14, samplate=s["samplate"],
               thresh=s["thresh"], device="cpu").synsq(
                   w, octave, plan.get_fre_band_arr())
    readings = ref.compare({"cwt": w, "synsq": sq},
                           ref.Reference(c, "cpu").run(x))
    limits = c["limits"]
    assert set(readings) == set(limits)
    assert all(readings[k] <= limits[k] for k in limits), readings
    # the squeeze moved most of the energy: there are ridges to hold
    assert float(sq.abs().amax()) > 2 * float(w.abs().amax())


@pytest.fixture
def tiny_bench(tmp_path):
    """The benchmark's folder with the wavelet cell cut to 2 clips of
    2^14 samples, one request in the pool and one call kept."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (here / "configs" / "cwt_synsq_32k.json").write_text(json.dumps(cfg(14)))
    path = here / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl.update(batch=2, samples=1 << 14, pool=1, keep=1)
    path.write_text(json.dumps(wl))
    return json.loads((ROOT / "BENCHMARK.json").read_text()), here


def plant(fault: str, out: dict) -> dict:
    """``half``: the second half of the batch's clips left out (zeros);
    ``alter``: one value of each output moved by a hundredth of its
    peak."""
    res = {}
    for k, v in out.items():
        v = v.clone()
        if fault == "half":
            v[v.shape[0] // 2:] = 0
        else:
            v.reshape(-1)[0] += 0.01 * float(v.abs().max())
        res[k] = v
    return res


def _run(tiny_bench, **kw):
    bench, here = tiny_bench
    return harness.run_cell(bench, CELL, 2**31 + 43, 0.2, False, time.time(),
                            device="cpu", here=here, log=lambda s: None, **kw)


def test_sound_run_is_correct(tiny_bench):
    res = _run(tiny_bench)
    assert res["correct"], res["check"]
    assert all(v["limit"] is not None for v in res["check"].values())


@pytest.mark.parametrize("fault", ["half", "alter", "bf16"])
def test_fault_is_not_correct(tiny_bench, fault, monkeypatch):
    if fault == "bf16":
        res = _run(tiny_bench, control="bf16")
    else:
        build = harness.build_entry

        class Faulty:
            def __init__(self, *args, **kw):
                self.entry = build(*args, **kw)

            def call(self, x, spans):
                return plant(fault, self.entry.call(x, spans))

        monkeypatch.setattr(harness, "build_entry", Faulty)
        res = _run(tiny_bench)
    assert not res["correct"], res["check"]
    if fault == "bf16":   # the control fails by the numbers, not a lost part
        assert res["check"]["cwt_gap"]["value"] < 0.1, res["check"]


def test_outputs_are_complex_where_the_program_keeps_them():
    x = torch.zeros(1, 1 << 14)
    out = ref.Reference(cfg(14), "cpu").run(x, "bf16")
    assert out["cwt"].dtype == torch.float32 and out["cwt"].shape[-1] == 2
    assert not out["synsq"].abs().any()
