"""The check on the card at a size a test run holds: the program's sound
run passes and the control (the plain reference in the configuration's
control precision, in the program's place) does not.  The readings at the
cells' own sizes come from ``run.py --calibrate``; see ``PERF.md``."""

import time

import pytest

from benchmark import harness

CELLS = ["mel_mfcc.corpus", "mir.corpus"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_on_the_card(card, tiny_bench, cell):
    bench, here = tiny_bench
    cfg = harness.cell_parts(bench, cell, here)["config"]
    kw = dict(device=card, here=here, log=lambda s: None)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        sound = harness.run_cell(bench, cell, seed, 0.2, False, time.time(), **kw)
        assert sound["correct"], sound["check"]
        control = harness.run_cell(bench, cell, seed, 0.2, False, time.time(),
                                   control=cfg["control"], **kw)
        assert not control["correct"], control["check"]
