"""Run one benchmark cell once and say where its set-up went, by the
program's set-up spans (``audioflux_torch.observe.setup``).

    python3 tools/setup_split.py --workload <cell> --seed <n> \
        [--seconds <s>] [--trace 0|1] [--out <file.json>]

The run is ``benchmark/run.py``'s (its clock starts when this script
imports it, before PyTorch's import).  Printed: the run's ``setup_s`` and,
with ``--trace 1``, the three metrics that split it; then each span name
with its count and seconds (nested spans count in each, so the names'
seconds overlap), and the union of each kind (``import``, ``plan``,
``table``, ``load``, ``build``, ``launch``).  Spans that end after the
set-up (a steady call that opened one) are listed apart.  ``--out`` writes
the same as JSON, with every span.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run as bench_run  # noqa: E402  (starts the clock)

P_START = time.perf_counter_ns() - round((time.time() - bench_run.T_START)
                                         * 1e9)

import argparse  # noqa: E402
import json  # noqa: E402
from collections import defaultdict  # noqa: E402


def split(spans, setup_end_ns):
    """{name: [count, seconds]}, {kind: union seconds}, late spans."""
    from benchmark.trace import union_length
    by_name = defaultdict(lambda: [0, 0.0])
    by_kind = defaultdict(list)
    late = []
    for name, parent, s, e in spans:
        if e > setup_end_ns:
            late.append((name, parent, s, e))
            continue
        by_name[name][0] += 1
        by_name[name][1] += (e - s) / 1e9
        by_kind[name.split(".")[2]].append((s, e))
    kinds = {k: union_length(ivs) / 1e9 for k, ivs in by_kind.items()}
    return dict(by_name), kinds, late


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmark import harness
    bench = harness.load_benchmark()
    logged = []

    def log(line):
        logged.append(line)
        print(line, file=sys.stderr)

    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), bench_run.T_START, log=log)
    setup_s, = [float(line.rsplit("setup_s ", 1)[1]) for line in logged
                if "; setup_s " in line]
    from audioflux_torch import observe
    spans = observe.setup_spans()
    by_name, kinds, late = split(spans, P_START + round(setup_s * 1e9))
    metrics = {k: v["value"] for k, v in result["metrics"].items()
               if k.startswith("setup_")}
    print(f"{args.workload} seed {args.seed}: correct {result['correct']}, "
          f"setup_s {setup_s:.4f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
    for kind, secs in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  kind {kind:8s} {secs:9.4f} s (union)")
    for name, (count, secs) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1]):
        print(f"  {name:60s} {count:4d} {secs:9.4f} s")
    for name, parent, s, e in late:
        print(f"  after the set-up: {name} (in {parent}) {(e - s) / 1e9:.6f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seed": args.seed,
                       "correct": result["correct"], "setup_s": setup_s,
                       "metrics": metrics, "kinds": kinds,
                       "by_name": by_name, "late": late,
                       "spans": [(n, p, (s - P_START) / 1e9,
                                  (e - P_START) / 1e9)
                                 for n, p, s, e in spans]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
