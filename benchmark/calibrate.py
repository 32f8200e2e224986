"""The readings the check's limits are set from: the program over many
seeds, and the plain reference in a lower precision (the control) over
three, each on every request of the cell's pool, at the cell's sizes."""

from __future__ import annotations

import gc
import json
import sys

import torch

from benchmark import harness, traffic

CONTROL_SEEDS = 3


def _readings(entry, cfg, wl, seed, dev):
    pool = traffic.make_pool(wl, seed, dev)
    outs = [(i, entry.call(x, harness._NoSpans())) for i, x in enumerate(pool)]
    one_clip = len(traffic.request_shape(wl)) == 1
    readings = harness.check(cfg, pool, outs, dev, one_clip)
    ref_mod = harness.module("reference", cfg["name"])
    if readings.get("pitch_flips") and hasattr(ref_mod, "explain"):
        ref = ref_mod.Reference(cfg, dev)
        for i, out in outs:
            for frame in ref_mod.explain(out, pool[i], ref):
                print(json.dumps({"seed": seed, "pool": i, **frame}),
                      file=sys.stderr, flush=True)
    del pool, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return readings


def run(bench: dict, name: str, seed: int, n: int, device=None) -> list:
    parts = harness.cell_parts(bench, name)
    cfg, wl = parts["config"], parts["workload"]
    dev = harness.device_for(parts["cell"]["chips"], device)
    lines = []
    sides = [("program", harness.build_entry(cfg, dev), n)]
    for prec in dict.fromkeys((cfg["control"], "bf16")):
        sides.append((f"control_{prec}", harness.ControlEntry(cfg, dev, prec),
                      CONTROL_SEEDS))
    for side, entry, count in sides:
        for s in range(seed, seed + count):
            line = {"side": side, "seed": s,
                    **_readings(entry, cfg, wl, s, dev)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    for key in lines[0]:
        if key in ("side", "seed"):
            continue
        for side, _, _ in sides:
            vals = [ln[key] for ln in lines if ln["side"] == side]
            print(f"{key} {side}: max {max(vals)} min {min(vals)}",
                  file=sys.stderr)
    return lines
