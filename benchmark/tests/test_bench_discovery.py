"""A configuration, a cell and a metric are added as new files and entries
in BENCHMARK.json, and the harness finds them by name: no file that is
already there is edited."""

import hashlib
import json
import time

from benchmark import harness


def digest(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_found_by_name(tiny_bench):
    bench, here = tiny_bench
    before = digest(here)
    cfg = json.loads((here / "configs" / "mel_mfcc_32k.json").read_text())
    cfg["name"] = "throwaway_cfg"
    cfg["plans"]["mel"]["num"] = 64
    cfg["limits"] = {}
    (here / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    (here / "reference" / "throwaway_cfg.py").write_text(
        "from benchmark.reference.mel_mfcc_32k import Reference, compare\n")
    (here / "counts" / "throwaway_cfg.py").write_text(
        "from benchmark.counts.mel_mfcc_32k import need\n")
    wl = json.loads((here / "workloads" / "mel_mfcc.corpus.json").read_text())
    wl["config"] = "throwaway_cfg"
    (here / "workloads" / "throwaway.cell.json").write_text(json.dumps(wl))
    (here / "metrics" / "throwaway.calls.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append({"name": "throwaway_cfg", "source": "test",
                             "file": "benchmark/configs/throwaway_cfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.cell", "config": "throwaway_cfg",
                               "traffic": "corpus", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "throwaway.calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry calls", "moves": "audio_hours_per_s",
                               "workloads": ["throwaway.cell"]})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "audio_hours_per_s")
    rate["workloads"].append("throwaway.cell")

    parts = harness.cell_parts(bench, "throwaway.cell", here)
    assert parts["config"]["plans"]["mel"]["num"] == 64
    assert [m["name"] for m in parts["per_layer"]] == ["throwaway.calls"]
    assert {m["name"] for m in parts["end_to_end"]} == {"audio_hours_per_s",
                                                        "setup_s"}
    res = harness.run_cell(bench, "throwaway.cell", 7, 0.2, True, time.time(),
                           device="cpu", here=here, log=lambda s: None)
    assert res["correct"]
    assert res["metrics"]["throwaway.calls"]["value"] >= 1
    after = digest(here)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/throwaway_cfg.json", "reference/throwaway_cfg.py",
        "counts/throwaway_cfg.py", "workloads/throwaway.cell.json",
        "metrics/throwaway.calls.py"}


def test_a_cell_of_single_requests_from_host_memory_is_data_alone(tiny_bench):
    """One clip a request, as a numpy array in host memory, features back
    as numpy: a workload file and an entry in BENCHMARK.json."""
    bench, here = tiny_bench
    before = digest(here)
    wl = {"config": "mel_mfcc_32k", "signal": "noise", "scale": 0.2,
          "samplate": 32000, "batch": None, "samples": 4096, "pool": 3,
          "io": "host", "keep": 6, "trace_calls": 4}
    (here / "workloads" / "throwaway.single.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": "throwaway.single", "config": "mel_mfcc_32k",
                               "traffic": "single", "chips": 1, "why": "test"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "audio_hours_per_s")
    rate["workloads"].append("throwaway.single")
    res = harness.run_cell(bench, "throwaway.single", 8, 0.2, False, time.time(),
                           device="cpu", here=here, log=lambda s: None)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 6
    assert set(res["metrics"]) == {"audio_hours_per_s", "setup_s"}
    after = digest(here)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"workloads/throwaway.single.json"}
