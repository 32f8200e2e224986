"""Fixtures of the benchmark's tests.

Tests marked ``card`` need an NVIDIA card; they take the ``card`` fixture,
which decides when the test runs (never at import) and skips without one.
Run them on the card with ``python3 -m pytest benchmark/tests -m card``.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny traffic for runs of the harness on the CPU: every cell at a size a
# test holds, the same keys as the cell's own file
TINY = {
    "mel_mfcc.corpus": {"batch": 3, "samples": 2048 + 512 * 7, "trace_calls": 3},
    "mir.corpus": {"batch": 2, "samples": 64000, "trace_calls": 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda:0")


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's folder whose workloads are cut to a size
    the CPU runs in a second; returns (BENCHMARK.json as a dict, the
    folder)."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, change in TINY.items():
        path = here / "workloads" / f"{name}.json"
        wl = json.loads(path.read_text())
        wl.update(change)
        path.write_text(json.dumps(wl))
    return json.loads((ROOT / "BENCHMARK.json").read_text()), here
