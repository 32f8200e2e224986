"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a small size: sound runs pass, and the control (the plain
reference in the configuration's control precision, in the program's
place) and every fault a cell can have (half of the batch's results left
out, one answer altered where it is produced) come out not correct."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness

CELLS = ["mel_mfcc.corpus", "mir.corpus"]
FAULTS = ("half", "alter")


def plant(fault: str, out: dict) -> dict:
    """``half``: the second half of the batch's results left out (zeros);
    ``alter``: one value of each output moved by a hundredth of its
    output's peak, one onset point moved by a frame."""
    res = {}
    for k, v in out.items():
        if isinstance(v, list):
            v = [np.asarray(r).copy() for r in v]
            if fault == "half":
                for i in range(len(v) // 2, len(v)):
                    v[i] = v[i][:0]
            elif v and len(v[0]):
                v[0][0] += 1
            res[k] = v
            continue
        v = v.clone() if isinstance(v, torch.Tensor) else np.array(v)
        if fault == "half":
            ax = 0 if v.shape[0] >= 2 else v.ndim - 1
            idx = [slice(None)] * v.ndim
            idx[ax] = slice(v.shape[ax] // 2, None)
            v[tuple(idx)] = 0
        else:
            peak = float(abs(v).max()) or 1.0
            v.reshape(-1)[0] += 0.01 * peak
        res[k] = v
    return res


def run(tiny_bench, cell, **kw):
    bench, here = tiny_bench
    return harness.run_cell(bench, cell, 2**31 + 11, 0.2, False, time.time(),
                            device="cpu", here=here, log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_bench, cell):
    res = run(tiny_bench, cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert all(v["limit"] is not None for v in res["check"].values())
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_bench, cell):
    bench, _ = tiny_bench
    cfg = harness.cell_parts(bench, cell)["config"]
    res = run(tiny_bench, cell, control=cfg["control"])
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_bench, cell, fault, monkeypatch):
    build = harness.build_entry

    class Faulty:
        def __init__(self, *args, **kw):
            self.entry = build(*args, **kw)

        def call(self, x, spans):
            return plant(fault, self.entry.call(x, spans))

    monkeypatch.setattr(harness, "build_entry", Faulty)
    res = run(tiny_bench, cell)
    assert not res["correct"], res["check"]
